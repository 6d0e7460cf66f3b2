// The enumeration leg's keep-best on the card (phasing/cuda_keep_best.py).
//
// Counterpart of the host loop that picks an enumeration region's winning
// configuration: the sequential, tie-quantized keep-best of
// longcallr_tpu/phasing/optimize.py (its enumeration leg) and
// longcallr_tpu/phasing/batch_driver.py (_phase_enum_bucket), which walk the
// configurations' objectives in enumeration order and take the first one
// that beats the running best by more than TIE_TOL. It replaces no Pallas
// kernel: like set_condition in graph_program.cu, it stands for control flow
// of the JAX package that ran on the host, so that a device program can end
// with the winner and the host reads no objective between the programs of a
// wave.
//
// One block takes one region's C objectives of a chunk of configurations,
// a tile at a time: its threads stage the tile in shared memory (coalesced,
// every load in flight at once), then its first warp walks the tile 32
// objectives a step, carrying the running best (read from `prev`, the best
// of the chunks before) and the index of the last configuration that beat
// it. A step's ballot finds the lanes that beat the running best; the first
// of them in order is the walk's next pick, whose value the warp shares,
// and the lanes after it ask again against the new best. An objective
// before the pick was at most the old best plus the tolerance, so below the
// new best plus it: the picks are those of the sequential rule, and each
// compare is the host loop's own (p > best + tol in float64). What bounds
// it: 8·C bytes read once (8 KiB at C = 1,024, 2.4 ns at 3.35 TB/s), far
// under a launch; the walk is C / 32 ballots and one more per pick.
//
// C interface (loaded with ctypes, beside split_matvec.cu): returns a
// cudaError_t as int (0 = success) and allocates no device memory.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;  // objectives a block stages at once (16 KiB)
constexpr unsigned kAll = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
keep_best_kernel(const double* __restrict__ probs, long long n,
                 const double* __restrict__ prev, double tol,
                 double* __restrict__ best, long long* __restrict__ index) {
  __shared__ double tile[kTile];
  const int lane = threadIdx.x & 31;
  double b = *prev;
  long long sel = -1;
  for (long long t0 = 0; t0 < n; t0 += kTile) {
    const int m = (int)(n - t0 < kTile ? n - t0 : kTile);
    __syncthreads();  // the walk is done with the tile before
    for (int i = threadIdx.x; i < m; i += kThreads) tile[i] = probs[t0 + i];
    __syncthreads();
    if (threadIdx.x < 32) {  // the first warp walks, all its lanes alike
      for (int c = 0; c < m; c += 32) {
        const int i = c + lane;
        const bool valid = i < m;
        const double p = valid ? tile[i] : 0.0;
        unsigned beat = __ballot_sync(kAll, valid && p > b + tol);
        while (beat) {
          const int first = __ffs(beat) - 1;
          b = __shfl_sync(kAll, p, first);
          sel = t0 + c + first;
          beat = __ballot_sync(kAll, valid && lane > first && p > b + tol);
        }
      }
    }
  }
  if (threadIdx.x == 0) {
    *best = b;
    *index = sel;
  }
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

// probs: f64 [n] contiguous; prev, best: f64 scalars; index: int64 scalar.
// best = the running best after probs[0..n), index = the position in probs
// of the configuration that set it, or -1 where none beat prev by more than
// tol (best is then prev). One block of kThreads threads on `stream`.
int keep_best(const double* probs, long long n, const double* prev,
              double tol, double* best, long long* index, int device,
              void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  OnDevice on(device);
  keep_best_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      probs, n, prev, tol, best, index);
  return (int)cudaGetLastError();
}

}  // extern "C"
