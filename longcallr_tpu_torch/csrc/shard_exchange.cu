// The reads-sharded ascent's exchange: the port's counterpart of the JAX
// package's jax.lax.psum over the "reads" axis inside sharded_cross_optimize
// (longcallr_tpu/parallel/mesh.py:536-539 the column sums, :554 the flip
// count, :558 dpᵀσ, :604 the objective). It stands for an XLA collective,
// not for a Pallas kernel.
//
// Each shard of a group runs the same device program (phasing/graphs.py,
// Group), and every program launches this kernel at the same points. Shard s
// writes its partial (f64 words, then int64 words) into slot s of every
// shard's exchange buffer (plain stores on one card, peer stores across
// cards), makes them visible with a system-scope fence and arrives: it stores
// the exchange's generation into its flag in every shard's flag array. It
// then waits, with acquire loads, until every shard's flag in its own array
// has reached the generation, and sums the n slots in shard order 0, 1, ...,
// n-1, the same adds as the plain version (cuda_exchange.sum_in_order), so
// every shard holds bit-identical totals and every shard's loop turns as
// often.
//
// The generation is the shard's count of exchanges (state[0]), kept in a
// buffer its program owns and never reset: every shard makes the same
// exchanges, so the generations agree across launches. The slots are
// double-buffered by the generation's parity: a shard that runs ahead into
// the next exchange writes the other half, and it cannot reach the one after
// (the same half) before every shard has arrived at the next, that is, has
// read this one. A flag only grows, so a shard waits for flag >= generation.
//
// The wait is bounded: past timeout_ns of the device clock (%globaltimer) the
// kernel traps, which the host sees as a CUDA error at its next sync (a
// raised error, never a hang). state[1] counts the exchanges (barrier turns)
// on the device; the host zeroes it before a launch and checks it against
// the runs of the program's loops.
//
// What bounds it: latency, not bytes. A slot is at most 4·I words (the
// prologue's three column sums and the coverage: 16 KiB at I = 512); one
// block of 256 threads writes n copies and sums n slots, a few µs, most of
// it the arrival of the slowest shard.
//
// C interface (ctypes, beside split_matvec.cu): sx_exchange launches the
// kernel on a stream of the shard's device and returns cudaGetLastError();
// sx_enable_peers enables peer access from one card to another.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// bufs[j]: shard j's buffer, [2][n][cap] 8-byte words; flags[j]: shard j's
// arrival flags, [n]; state: this shard's [generation, barrier turns].
__global__ void __launch_bounds__(kThreads) shard_exchange_kernel(
    int s, int n, int cap, unsigned long long* const* bufs,
    unsigned long long* const* flags, long long* state, const double* fpart,
    int wf, const long long* ipart, int wi, double* ftotal, long long* itotal,
    long long timeout_ns) {
  const unsigned long long g = (unsigned long long)state[0] + 1;
  const int half = (int)(g & 1ull) * n * cap;
  const int w = wf + wi;
  // publish: this shard's partial into slot s of every shard's buffer
  for (int j = 0; j < n; ++j) {
    unsigned long long* slot = bufs[j] + half + s * cap;
    for (int k = threadIdx.x; k < w; k += kThreads) {
      slot[k] = k < wf ? (unsigned long long)__double_as_longlong(fpart[k])
                       : (unsigned long long)ipart[k - wf];
    }
  }
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int j = 0; j < n; ++j) store_release(flags[j] + s, g);
    // wait until every shard has published this generation to this shard
    const unsigned long long t0 = now_ns();
    for (int j = 0; j < n; ++j) {
      while (load_acquire(flags[s] + j) < g) {
        if (now_ns() - t0 > (unsigned long long)timeout_ns) __trap();
        __nanosleep(64);
      }
    }
  }
  __syncthreads();
  // sum the slots in shard order (loads that bypass L1: peers wrote them)
  const unsigned long long* mine = bufs[s] + half;
  for (int k = threadIdx.x; k < w; k += kThreads) {
    if (k < wf) {
      double t = __longlong_as_double(__ldcv((const long long*)mine + k));
      for (int j = 1; j < n; ++j)
        t = __dadd_rn(t, __longlong_as_double(
                             __ldcv((const long long*)mine + j * cap + k)));
      ftotal[k] = t;
    } else {
      long long t = __ldcv((const long long*)mine + k);
      for (int j = 1; j < n; ++j)
        t += __ldcv((const long long*)mine + j * cap + k);
      itotal[k - wf] = t;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    state[0] = (long long)g;
    state[1] += 1;
  }
}

}  // namespace

extern "C" {

// One shard's exchange on `stream` of `device`. ptrs: a device
// array of 2n words on this shard's device, the n buffers' addresses then the
// n flag arrays'. fpart/ftotal may be null where wf = 0, ipart/itotal where
// wi = 0.
int sx_exchange(int device, int s, int n, int cap, void* ptrs, void* state,
                const void* fpart, int wf, const void* ipart, int wi,
                void* ftotal, void* itotal, long long timeout_ns,
                void* stream) {
  if (n < 1 || s < 0 || s >= n || wf < 0 || wi < 0 || wf + wi > cap)
    return (int)cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess && prev != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  unsigned long long* const* p = (unsigned long long* const*)ptrs;
  // this library's runtime keeps its own last error: drop one that an
  // earlier call already returned to its caller, so the check below is
  // this launch's
  cudaGetLastError();
  shard_exchange_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      s, n, cap, p, p + n, (long long*)state, (const double*)fpart, wf,
      (const long long*)ipart, wi, (double*)ftotal, (long long*)itotal,
      timeout_ns);
  e = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return (int)e;
}

// Let `device` reach `peer`'s memory (already enabled counts as success);
// cudaErrorPeerAccessUnsupported where the cards cannot reach each other.
int sx_enable_peers(int device, int peer) {
  int can = 0;
  cudaError_t e = cudaDeviceCanAccessPeer(&can, device, peer);
  if (e != cudaSuccess) return (int)e;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  int prev = 0;
  cudaGetDevice(&prev);
  e = cudaSetDevice(device);
  if (e == cudaSuccess) {
    e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();
      e = cudaSuccess;
    }
  }
  cudaSetDevice(prev);
  return (int)e;
}

}  // extern "C"
