// A loop whose exit is decided on the device, inside a CUDA graph: the
// counterpart of the JAX package's lax.while_loop in the graphed tracked
// frame (slam/tracker.py::TrackGraphs, ops/device_loop.py).
//
// While a stream is being captured, graph_loop_begin appends to the graph
// under capture a kernel that sets a conditional handle from a device flag
// ("live") and a step counter, then a conditional WHILE node that runs while
// the handle is non-zero, and starts capturing the loop's body on a second
// stream into the node's body graph. graph_loop_end appends to the body the
// same kernel (counting the step, re-reading the flag) and ends the body's
// capture. The body is one loop step captured once; on replay it runs while
// the flag holds and the count is under the cap, so the steps after the
// exit cost nothing (the eager form of the loop runs every step masked).
//
// A graph with conditional nodes is instantiated and launched here too
// (graph_loop_instantiate, graph_loop_launch, graph_loop_destroy).
// Conditional nodes need CUDA 12.4 or later.

#include <cuda_runtime.h>

namespace {

// count = 0 (start) or count + 1 (after a step); the loop goes on while
// live && count < cap
__global__ void loop_condition_kernel(cudaGraphConditionalHandle handle,
                                      const bool* live, int* count, int cap,
                                      int start) {
  const int c = start ? 0 : *count + 1;
  *count = c;
  cudaGraphSetConditional(handle, (*live && c < cap) ? 1u : 0u);
}

}  // namespace

// outer: the stream under capture; body: an idle stream that captures the
// loop's body; live: a device bool; count: a device int (the loop's scratch);
// cap: the most steps; handle_out: an unsigned long long the handle is
// written to, for graph_loop_end.
extern "C" int graph_loop_begin(void* outer, void* body, const void* live,
                                void* count, int cap, void* handle_out) {
  cudaStream_t so = static_cast<cudaStream_t>(outer);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t e = cudaStreamGetCaptureInfo(so, &status, nullptr, &graph);
  if (e != cudaSuccess) return int(e);
  if (status != cudaStreamCaptureStatusActive || cap < 0)
    return int(cudaErrorInvalidValue);
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return int(e);
  loop_condition_kernel<<<1, 1, 0, so>>>(
      handle, static_cast<const bool*>(live), static_cast<int*>(count), cap,
      1);
  e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  e = cudaStreamGetCaptureInfo(so, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return int(e);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return int(e);
  e = cudaStreamUpdateCaptureDependencies(so, &node, 1,
                                          cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return int(e);
  e = cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body),
                                    params.conditional.phGraph_out[0],
                                    nullptr, nullptr, 0,
                                    cudaStreamCaptureModeThreadLocal);
  if (e != cudaSuccess) return int(e);
  *static_cast<unsigned long long*>(handle_out) = handle;
  return int(cudaSuccess);
}

// body, live, count, cap: as given to graph_loop_begin; handle: the
// unsigned long long it wrote.
extern "C" int graph_loop_end(void* body, const void* live, void* count,
                              int cap, const void* handle) {
  cudaStream_t sb = static_cast<cudaStream_t>(body);
  loop_condition_kernel<<<1, 1, 0, sb>>>(
      *static_cast<const unsigned long long*>(handle),
      static_cast<const bool*>(live), static_cast<int*>(count), cap, 0);
  cudaError_t e = cudaGetLastError();
  cudaGraph_t graph;
  const cudaError_t e_end = cudaStreamEndCapture(sb, &graph);
  return int(e != cudaSuccess ? e : e_end);
}

// Instantiates a captured graph that holds conditional nodes (which do not
// take PyTorch's cudaGraphInstantiateFlagAutoFreeOnLaunch) into *exec_out;
// on failure *node_type_out is the type of the node at fault, else -1.
extern "C" int graph_loop_instantiate(void* graph, void* exec_out,
                                      void* node_type_out) {
  cudaGraphInstantiateParams params = {};
  cudaError_t e = cudaGraphInstantiateWithParams(
      static_cast<cudaGraphExec_t*>(exec_out),
      static_cast<cudaGraph_t>(graph), &params);
  int* type = static_cast<int*>(node_type_out);
  *type = -1;
  if (e != cudaSuccess && params.errNode_out != nullptr) {
    cudaGraphNodeType t;
    if (cudaGraphNodeGetType(params.errNode_out, &t) == cudaSuccess)
      *type = int(t);
  }
  return int(e);
}

extern "C" int graph_loop_launch(void* exec, void* stream) {
  return int(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                             static_cast<cudaStream_t>(stream)));
}

extern "C" int graph_loop_destroy(void* exec) {
  return int(cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec)));
}

extern "C" const char* graph_loop_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
