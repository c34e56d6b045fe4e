// Conditional IF nodes in a CUDA graph under stream capture: the counterpart,
// inside a captured frame program, of jax.lax.cond in the JAX package's cached
// shadow atlas (renderer_tpu/ops/shadow.py:657-690, "cond, not where"). Not
// the port of a TPU kernel: it lets a replayed frame skip an unselected
// atlas slot's whole cull, expansion and raster on the device
// (ops/control.py's cond).
//
// rtt_cond_begin appends to the capture of `stream` a one-thread kernel that
// sets a new conditional handle from *pred at every launch of the graph, and
// behind it an IF node; the node becomes the stream's capture dependency, so
// what the stream captures next runs after it. The node's body graph is
// returned empty: the caller captures the body into it on another stream
// (rtt_capture_to_graph ... rtt_capture_end). What bounds it: one launch of
// one thread per node and replay, nothing else.
//
// Needs the CUDA runtime 12.4 or later (cudaStreamBeginCaptureToGraph,
// conditional nodes).

#include <cuda_runtime.h>

namespace {

__global__ void set_cond_kernel(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

// `pred` is one bool on the device, read when the graph runs. Returns a
// cudaError_t (0 on success); *body is the IF node's body graph.
extern "C" int rtt_cond_begin(const bool* pred, void** body, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive) return (int)cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return (int)err;
  set_cond_kernel<<<1, 1, 0, s>>>(handle, pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return (int)err;
  *body = (void*)params.conditional.phGraph_out[0];
  return (int)cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
}

// Loads the module of the handle's kernel, so that no lazy load happens
// inside a capture.
extern "C" int rtt_cond_load() {
  cudaFuncAttributes attr;
  return (int)cudaFuncGetAttributes(&attr, set_cond_kernel);
}

// A stream of its own (not one of PyTorch's pool, which hands its 32
// streams out in turn), for captures: *stream receives the handle.
extern "C" int rtt_stream_create(void** stream) {
  return (int)cudaStreamCreateWithFlags((cudaStream_t*)stream, cudaStreamNonBlocking);
}

// Starts capturing `stream` (idle, not capturing) into `graph`.
extern "C" int rtt_capture_to_graph(void* graph, void* stream) {
  return (int)cudaStreamBeginCaptureToGraph((cudaStream_t)stream, (cudaGraph_t)graph, nullptr,
                                            nullptr, 0, cudaStreamCaptureModeGlobal);
}

// Ends the capture rtt_capture_to_graph started.
extern "C" int rtt_capture_end(void* stream) {
  cudaGraph_t graph;
  return (int)cudaStreamEndCapture((cudaStream_t)stream, &graph);
}
