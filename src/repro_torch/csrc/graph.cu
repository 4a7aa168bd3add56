// A captured CUDA graph's size, for the captured HPCG solve
// (repro_torch.solvers.CapturedSolve). Not a kernel: it replaces no TPU
// kernel and launches nothing. The reference compiles its timed solve into
// one XLA program; the port captures it into one cudaGraph_t, and this
// entry counts that graph's nodes (kernels, copies, memsets) through the
// runtime, which PyTorch's Python API does not expose.
#include <cuda_runtime.h>

extern "C" int repro_graph_nodes(void* graph, long long* count) {
  size_t n = 0;
  const cudaError_t err = cudaGraphGetNodes(static_cast<cudaGraph_t>(graph), nullptr, &n);
  *count = static_cast<long long>(n);
  return static_cast<int>(err);
}
