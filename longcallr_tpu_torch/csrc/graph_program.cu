// Device programs of the phase: CUDA graphs with conditional WHILE nodes,
// composed from pieces that PyTorch captured (phasing/graphs.py, Program).
//
// Counterpart of jax.jit over the JAX package's phase programs, whose loops
// run on the device: the ascents' lax.while_loop
// (longcallr_tpu/phasing/optimize.py:232) and the perturbation schedule's
// fori_loop over rounds (longcallr_tpu/parallel/mesh.py:285), inside
// batched_phase_fused (longcallr_tpu/parallel/mesh.py:391-460) and
// perturbation_phase. This is control flow, not the port of a Pallas
// kernel: the kernels it runs are the pieces' (the hand matvecs of
// split_matvec.cu among them).
//
// A program is a parent graph built once per shape: a chain of child-graph
// nodes (each a clone of a piece's captured graph) and WHILE nodes. Before a
// WHILE node, and as the last node of its body, a one-thread kernel reads the
// loop's continue flag (a bool that the pieces write on the device) and sets
// the node's condition with cudaGraphSetConditional. Every such launch adds 1
// to the program's count of set-condition launches, and the one at the end
// of a body also to the loop's counter of body runs; the host reads both
// once after the launch to count the launches the bodies made. So no flag
// leaves the device while the program runs. Nested WHILE nodes (a round
// loop holding the ascents' loops) need CUDA 12.4 or later.
//
// What bounds it: the set-condition kernel is one thread and a few 8-byte
// accesses, a launch's fixed cost (a few µs) per loop turn.
//
// gp_stamp launches a one-thread kernel that writes the device clock
// (%globaltimer, ns) into the next slot of a buffer: a piece that calls it is
// captured with it, so a program's pieces can be timed on the device where
// no event may stand (inside a conditional node's body). chip_smoke.py uses
// it to measure where a program's time goes; the phase's programs do not.
//
// C interface (loaded with ctypes, beside split_matvec.cu): graphs, nodes,
// handles and executable graphs travel as opaque pointers and integers; each
// function returns a cudaError_t as int (0 = success) and allocates no device
// memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle,
                                     const bool* flag, long long* body_runs,
                                     long long* sets) {
  if (body_runs) *body_runs += 1;
  *sets += 1;
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

__global__ void stamp_kernel(unsigned long long* times, unsigned int* next,
                             unsigned int cap) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const unsigned int i = *next;
  if (i < cap) times[i] = t;
  *next = i + 1;
}

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

// The dependency list of a node appended after `dep` (none where it is null).
inline size_t deps_of(void* dep, cudaGraphNode_t* out) {
  *out = (cudaGraphNode_t)dep;
  return dep ? 1 : 0;
}

}  // namespace

extern "C" {

// A new empty graph on `device`.
int gp_graph_create(int device, void** graph) {
  OnDevice on(device);
  cudaGraph_t g = nullptr;
  cudaError_t e = cudaGraphCreate(&g, 0);
  *graph = g;
  return (int)e;
}

// Append a child-graph node (a clone of `child`) to `graph` after `dep`.
int gp_add_child(void* graph, void* dep, void* child, void** node) {
  cudaGraphNode_t d, n = nullptr;
  const size_t nd = deps_of(dep, &d);
  cudaError_t e = cudaGraphAddChildGraphNode(&n, (cudaGraph_t)graph,
                                             nd ? &d : nullptr, nd,
                                             (cudaGraph_t)child);
  *node = n;
  return (int)e;
}

// A condition handle for a conditional node of `graph` (value 0 until a
// kernel sets it).
int gp_handle_create(void* graph, unsigned long long* handle) {
  cudaGraphConditionalHandle h = 0;
  cudaError_t e = cudaGraphConditionalHandleCreate(&h, (cudaGraph_t)graph, 0,
                                                   0);
  *handle = (unsigned long long)h;
  return (int)e;
}

// Append to `graph` after `dep` the kernel that sets `handle` from the bool
// at `flag`, adds 1 to the int64 at `sets` and, where `body_runs` is not
// null, 1 to the int64 there.
int gp_add_set(void* graph, void* dep, unsigned long long handle,
               const bool* flag, long long* body_runs, long long* sets,
               void** node) {
  cudaGraphConditionalHandle h = (cudaGraphConditionalHandle)handle;
  void* args[] = {&h, (void*)&flag, (void*)&body_runs, (void*)&sets};
  cudaKernelNodeParams p = {};
  p.func = (void*)set_condition_kernel;
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  cudaGraphNode_t d, n = nullptr;
  const size_t nd = deps_of(dep, &d);
  cudaError_t e = cudaGraphAddKernelNode(&n, (cudaGraph_t)graph,
                                         nd ? &d : nullptr, nd, &p);
  *node = n;
  return (int)e;
}

// Append to `graph` after `dep` a WHILE node on `handle`; *body receives its
// (empty) body graph, which the caller fills.
int gp_add_while(void* graph, void* dep, unsigned long long handle,
                 void** node, void** body) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = (cudaGraphConditionalHandle)handle;
  p.conditional.type = cudaGraphCondTypeWhile;
  p.conditional.size = 1;
  cudaGraphNode_t d, n = nullptr;
  const size_t nd = deps_of(dep, &d);
  cudaError_t e = cudaGraphAddNode(&n, (cudaGraph_t)graph, nd ? &d : nullptr,
                                   nd, &p);
  *node = n;
  *body = e == cudaSuccess ? p.conditional.phGraph_out[0] : nullptr;
  return (int)e;
}

// Instantiate `graph` on `device` into *exec.
int gp_instantiate(void* graph, int device, void** exec) {
  OnDevice on(device);
  cudaGraphExec_t x = nullptr;
  cudaError_t e = cudaGraphInstantiate(&x, (cudaGraph_t)graph, 0);
  *exec = x;
  return (int)e;
}

// Launch `exec` on `stream` of `device`; nothing waits for it.
int gp_launch(void* exec, int device, void* stream) {
  OnDevice on(device);
  // drop a last error that an earlier call already returned to its caller
  // (this library's runtime keeps its own), so the check below is this
  // launch's
  cudaGetLastError();
  cudaError_t e = cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Destroy an executable graph and the graph it came from (either may be
// null).
int gp_destroy(void* exec, void* graph) {
  cudaError_t e = cudaSuccess;
  if (exec) e = cudaGraphExecDestroy((cudaGraphExec_t)exec);
  if (graph) {
    cudaError_t f = cudaGraphDestroy((cudaGraph_t)graph);
    if (e == cudaSuccess) e = f;
  }
  return (int)e;
}

// Launch on `stream` the kernel that writes the device clock into
// times[*next] (where *next < cap) and adds 1 to *next.
int gp_stamp(void* stream, unsigned long long* times, unsigned int* next,
             unsigned int cap) {
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(times, next, cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
