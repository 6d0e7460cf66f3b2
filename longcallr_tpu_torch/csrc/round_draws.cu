// The perturbation schedule's round draws, written by hand for Hopper (sm_90a).
//
// Replaces an XLA computation, not a Pallas kernel: the draws that the JAX
// package's phase programs make on the device inside their jax.jit,
//   longcallr_tpu/parallel/mesh.py:224-232   _draws, vmapped over a bucket's
//       keys (batched_perturbation_phase, batched_phase_fused)
//   longcallr_tpu/phasing/optimize.py:381-397   the pre-draw of one region
//       (perturbation_phase, perturbation_phase_stats)
// For region b and round t, with jax.random's threefry2x32 as it is under
// jax_threefry_partitionable=True:
//   kr = threefry2x32(key_b, (0, t))                          fold_in
//   k1 = threefry2x32(kr, (0, 0)), k2 = threefry2x32(kr, (0, 1))   split
//   rg[t, b, i] = u(threefry2x32(k1, (i >> 32, i & 0xFFFFFFFF)))   uniform [I]
//   fl[t, b, k] = u(threefry2x32(k2, (k >> 32, k & 0xFFFFFFFF)))   uniform [K]
//   u(b0, b1) = max(0, f64 of the bits ((b0:b1) >> 12) | 0x3FF0000000000000 − 1)
// Everything up to the subtraction is integer work, and the subtraction is
// exact (the value lies in [1, 2)), so the draws equal phasing/rng.py's and
// jax.random's bit for bit. Element i of a draw depends on i and its key
// alone: the first m values of a draw of length n are a draw of length m, and
// round t depends on t alone, so the caller draws only the rounds its loop runs.
//
// What bounds it: integer operations. A value is one 20-round hash, about 81
// 32-bit operations (77 for the hash, 4 to make the double), for 8 bytes
// written. At the H100's 16.7 T int32 operations/s (64 INT32 lanes per SM, 132
// SMs, 1.98 GHz) that is 4.8 ps a value, against 2.4 ps for its 8 bytes at
// 3.35 TB/s; the deep bucket (4 regions, 129 rounds, I 512, K 4096) is 2.4 M
// values, 19 MB: about 11.5 µs of operations, 5.7 µs of bytes.
//
// Design: the grid is (element blocks over I + K, rounds, regions). Threads 0
// and 1 of a block derive k1 and k2 of its (region, round) into shared memory
// (one fold_in and one split each); then every thread hashes one element and
// stores one double, adjacent threads on adjacent addresses. A rotation is one
// funnel shift. Nothing is read but the keys.
//
// C interface (loaded with ctypes, beside split_matvec.cu): round_draws
// launches on the given device and stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGridYZMax = 65535;   // CUDA's limit on grid.y and grid.z

__device__ __forceinline__ int rotation(int i, int j) {
  return (i & 1) ? (j == 0 ? 17 : j == 1 ? 29 : j == 2 ? 16 : 24)
                 : (j == 0 ? 13 : j == 1 ? 15 : j == 2 ? 26 : 6);
}

// Threefry-2x32, 20 rounds, as jax lowers it: key k, counter x.
__device__ __forceinline__ uint2 threefry2x32(uint2 k, uint2 x) {
  const uint32_t ks[3] = {k.x, k.y, k.x ^ k.y ^ 0x1BD11BDAu};
  uint32_t x0 = x.x + ks[0], x1 = x.y + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, rotation(i, j)) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return make_uint2(x0, x1);
}

// 64 random bits → a double in [0, 1): the top 52 as the mantissa of a number
// in [1, 2), minus 1.
__device__ __forceinline__ double unit_interval(uint2 b) {
  const unsigned long long bits =
      ((((unsigned long long)b.x << 32) | b.y) >> 12) | 0x3FF0000000000000ull;
  return fmax(0.0, __longlong_as_double((long long)bits) - 1.0);
}

// keys: int64 [B, 2], the uint32 words of each region's key in the low 32
// bits; rg: f64 [R, B, I]; fl: f64 [R, B, K]. Grid (ceil((I + K) / kThreads),
// rounds, keys) from round t0 and key b0 on: block (x, y, z) writes elements
// x·kThreads … of row (t0 + y, b0 + z) of rg then fl, taken as one row of
// I + K.
__global__ void __launch_bounds__(kThreads)
round_draws_kernel(const long long* __restrict__ keys, double* __restrict__ rg,
                   double* __restrict__ fl, int B, int I, int K, int t0,
                   int b0) {
  __shared__ uint2 sub[2];
  const int t = t0 + blockIdx.y, b = b0 + blockIdx.z;
  if (threadIdx.x < 2) {
    const uint2 key = make_uint2((uint32_t)keys[2 * b], (uint32_t)keys[2 * b + 1]);
    const uint2 kr = threefry2x32(key, make_uint2(0u, (uint32_t)t));
    sub[threadIdx.x] = threefry2x32(kr, make_uint2(0u, threadIdx.x));
  }
  __syncthreads();
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (long long)I + K) return;
  const bool first = e < I;
  const long long i = first ? e : e - I;
  const double v = unit_interval(threefry2x32(
      sub[first ? 0 : 1], make_uint2((uint32_t)(i >> 32), (uint32_t)i)));
  const long long row = (long long)t * B + b;
  if (first)
    rg[row * I + i] = v;
  else
    fl[row * K + i] = v;
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

// keys: int64 [B, 2] contiguous (the uint32 words of each key); rg: f64
// [R, B, I] and fl: f64 [R, B, K], contiguous. Rounds lie on the grid's
// second dimension and keys on its third, 65,535 a launch: more of either
// go in as many launches on the stream, each value computed as in one.
// Nothing is launched where R, B or I + K is 0.
int round_draws(const long long* keys, double* rg, double* fl, int B, int R,
                int I, int K, int device, void* stream) {
  if (B < 0 || R < 0 || I < 0 || K < 0) return (int)cudaErrorInvalidValue;
  if (!B || !R || !(I + K)) return (int)cudaSuccess;
  OnDevice on(device);
  const long long blocks = ((long long)I + K + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  for (int t0 = 0; t0 < R; t0 += kGridYZMax) {
    for (int b0 = 0; b0 < B; b0 += kGridYZMax) {
      dim3 grid((unsigned)blocks, min(R - t0, kGridYZMax),
                min(B - b0, kGridYZMax));
      round_draws_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
          keys, rg, fl, B, I, K, t0, b0);
      cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
  }
  return (int)cudaSuccess;
}

}  // extern "C"
