// Device stage marks (wrapper: stif_tpu_torch/utils/trace.py).
//
// A stage's start and end are each one launch of a one-thread kernel on the
// stream that runs the stage, so the marks are stream-ordered with the
// stage's work, and a captured CUDA graph holds them as two kernel nodes
// that every replay runs. The table is int64 [slots, 3]: the stage's last
// start (%globaltimer, ns), its summed time in ns and its count. The start
// kernel writes the start; the end kernel adds (now - start) to the sum and
// 1 to the count. One stream writes a table at a time and its kernels run
// in order, so no atomics are needed.

#include <cuda_runtime.h>

__global__ void stage_mark_kernel(long long* table, int slot, int end) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  long long* row = table + 3 * slot;
  if (end) {
    row[1] += (long long)now - row[0];
    row[2] += 1;
  } else {
    row[0] = (long long)now;
  }
}

extern "C" int stage_mark(void* table, int slot, int end, void* stream) {
  if (table == nullptr || slot < 0) return (int)cudaErrorInvalidValue;
  stage_mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(table), slot, end);
  return (int)cudaGetLastError();
}

// The node count of a captured (not yet destroyed) graph, or -error.
extern "C" long long stage_graph_nodes(void* graph) {
  size_t n = 0;
  cudaError_t err =
      cudaGraphGetNodes(static_cast<cudaGraph_t>(graph), nullptr, &n);
  return err == cudaSuccess ? (long long)n : -(long long)err;
}
