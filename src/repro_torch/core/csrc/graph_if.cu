// CUDA graphs with conditional IF nodes, captured from streams.
//
// The fused engine (core/capture.py) records a step of a vertex program
// as a CUDA graph whose data-dependent choices are IF nodes: the
// predicate is a bool in device memory, a one-thread kernel copies it
// into the node's conditional handle (cudaGraphSetConditional), and the
// body runs only when it is set.  Bodies are recorded by capturing a
// second stream into the node's body graph, so the ops of a branch are
// the same PyTorch ops the eager engine runs.  Needs CUDA 12.4 or later
// (nested bodies, cudaStreamBeginCaptureToGraph).
//
// Plain C interface for ctypes; every entry point returns the
// cudaError_t of its first failing call (0 on success).
#include <cuda_runtime.h>

namespace {

__global__ void set_if_kernel(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

#define CHECK(call)                              \
  do {                                           \
    const cudaError_t err_ = (call);             \
    if (err_ != cudaSuccess) return static_cast<int>(err_); \
  } while (0)

extern "C" {

const char* graph_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Loads the predicate kernel now, so that no module load happens inside
// a capture.
int graph_init() {
  cudaFuncAttributes attr;
  CHECK(cudaFuncGetAttributes(&attr, set_if_kernel));
  return 0;
}

// Starts recording `stream` into a new graph (thread-local capture mode:
// an unsafe call of this thread fails the capture).
int graph_capture_begin(void* stream) {
  CHECK(cudaStreamBeginCapture(static_cast<cudaStream_t>(stream),
                               cudaStreamCaptureModeThreadLocal));
  return 0;
}

// Ends the recording of `stream`; the graph it recorded, if any, goes to
// *graph_out.
int graph_capture_end(void* stream, void** graph_out) {
  cudaGraph_t graph = nullptr;
  const cudaError_t err =
      cudaStreamEndCapture(static_cast<cudaStream_t>(stream), &graph);
  *graph_out = graph;
  return static_cast<int>(err);
}

// The capture status of `stream`: 0 none, 1 active, 2 invalidated.
int graph_capture_status(void* stream, int* status_out) {
  cudaStreamCaptureStatus status;
  CHECK(cudaStreamIsCapturing(static_cast<cudaStream_t>(stream), &status));
  *status_out = static_cast<int>(status);
  return 0;
}

int graph_instantiate(void* graph, void** exec_out) {
  cudaGraphExec_t exec = nullptr;
  CHECK(cudaGraphInstantiate(&exec, static_cast<cudaGraph_t>(graph), 0));
  *exec_out = exec;
  return 0;
}

int graph_launch(void* exec, void* stream) {
  CHECK(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                        static_cast<cudaStream_t>(stream)));
  return 0;
}

int graph_destroy(void* graph, void* exec) {
  if (exec) CHECK(cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec)));
  if (graph) CHECK(cudaGraphDestroy(static_cast<cudaGraph_t>(graph)));
  return 0;
}

// Appends to the graph that `parent` is capturing: a kernel that sets a
// new conditional handle from the device bool `pred`, then an IF node on
// that handle; `parent` continues after the node, and `child` starts
// capturing into the node's body until graph_if_end.
int graph_if_begin(void* parent, const bool* pred, void* child) {
  const cudaStream_t ps = static_cast<cudaStream_t>(parent);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  CHECK(cudaStreamGetCaptureInfo(ps, &status, nullptr, &graph, &deps,
                                 &n_deps));
  if (status != cudaStreamCaptureStatusActive) {
    return static_cast<int>(cudaErrorStreamCaptureImplicit);
  }
  cudaGraphConditionalHandle handle;
  CHECK(cudaGraphConditionalHandleCreate(&handle, graph, 0, 0));
  set_if_kernel<<<1, 1, 0, ps>>>(handle, pred);
  CHECK(cudaGetLastError());
  CHECK(cudaStreamGetCaptureInfo(ps, &status, nullptr, &graph, &deps,
                                 &n_deps));
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  CHECK(cudaGraphAddNode(&node, graph, deps, n_deps, &params));
  CHECK(cudaStreamUpdateCaptureDependencies(
      ps, &node, 1, cudaStreamSetCaptureDependencies));
  CHECK(cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(child), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal));
  return 0;
}

// Ends the capture of an IF node's body.
int graph_if_end(void* child) {
  cudaGraph_t body = nullptr;
  CHECK(cudaStreamEndCapture(static_cast<cudaStream_t>(child), &body));
  return 0;
}

}  // extern "C"
