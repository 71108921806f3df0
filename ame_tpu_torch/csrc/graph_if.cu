// CUDA conditional (IF) nodes recorded during stream capture: the port's
// counterpart of lax.cond inside a captured CUDA graph (CUDA 12.4 and later).
//
// graph_if_begin, called while `stream` captures a graph, records into that
// graph a one-thread kernel that reads the predicate byte and sets the
// node's condition with cudaGraphSetConditional, then a conditional node of
// type IF after it, makes the node the capture's only dependency (work
// captured after it runs after it), and starts capturing `body_stream` into
// the node's body graph. graph_if_end ends that capture. At every replay the
// kernel reads the byte the graph's earlier nodes wrote, and the body runs
// where it is non-zero. Nothing is read on the host.
//
// Plain C interface for ctypes (ops/_branch.py); the entries return 0 or a
// cudaError_t code, which graph_if_error names.

#include <cuda_runtime.h>

__global__ void graph_if_set(cudaGraphConditionalHandle handle,
                             const unsigned char* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

// Loads the setter kernel's module (lazy loading would otherwise load it
// inside the first capture).
extern "C" int graph_if_load() {
  cudaFuncAttributes attr;
  return (int)cudaFuncGetAttributes(&attr, graph_if_set);
}

// A stream of the caller's own for IF bodies, on the current device: not
// one of torch's pooled streams, which other code (a graph capture's own
// stream among them) may be handed as well.
extern "C" int graph_if_stream(void** stream) {
  return (int)cudaStreamCreateWithFlags((cudaStream_t*)stream,
                                        cudaStreamNonBlocking);
}

extern "C" int graph_if_begin(void* stream, const void* pred,
                              void* body_stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph,
                                             &deps, &ndeps);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive)
    return (int)cudaErrorIllegalState;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                         cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return (int)err;
  graph_if_set<<<1, 1, 0, s>>>(handle, (const unsigned char*)pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the setter kernel is now the capture's dependency: the node follows it
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamBeginCaptureToGraph(
      (cudaStream_t)body_stream, params.conditional.phGraph_out[0], nullptr,
      nullptr, 0, cudaStreamCaptureModeRelaxed);
}

extern "C" int graph_if_end(void* body_stream) {
  cudaGraph_t body;
  return (int)cudaStreamEndCapture((cudaStream_t)body_stream, &body);
}

extern "C" const char* graph_if_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
