// fear_mark<k>: an empty kernel of one thread that marks where layer k of a
// tracking step begins inside a captured CUDA graph
// (feartracker_tpu_torch/utils/tracing.py, `mark`; k indexes its LAYERS).
//
// It replaces no TPU kernel. A graph replay launches all of its kernels from
// one cudaGraphLaunch, so a device trace cannot tell which layer a replayed
// kernel belongs to; with tracing on, each layer of each captured step begins
// with this launch, and a trace reads the layers off the kernel names in time
// order. It does no work: its cost is a launch slot inside the graph, about
// 2 us. Nothing launches it with tracing off, so unmarked graphs are
// unchanged.

#include <cuda_runtime.h>

template <int K>
__global__ void fear_mark() {}

extern "C" int fear_mark_launch(int layer, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (layer) {
    case 0: fear_mark<0><<<1, 1, 0, s>>>(); break;
    case 1: fear_mark<1><<<1, 1, 0, s>>>(); break;
    case 2: fear_mark<2><<<1, 1, 0, s>>>(); break;
    case 3: fear_mark<3><<<1, 1, 0, s>>>(); break;
    case 4: fear_mark<4><<<1, 1, 0, s>>>(); break;
    case 5: fear_mark<5><<<1, 1, 0, s>>>(); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
