// Step marks: five named kernels that do nothing, launched at the section
// boundaries of a training step (utils/profiling.py `mark`):
//
//     recsys_mark_begin      before the step's batch (index draw, gather)
//     recsys_mark_forward    before the model's forward
//     recsys_mark_backward   before the backward
//     recsys_mark_optimizer  before the optimizer's update
//     recsys_mark_end        after the step's last write
//
// and four for each unit of a model inside those sections (DIN's two
// attention units, models/din.py; DLRM's low-rank cross stack and its
// embedding bags, models/dlrm.py):
//
//     recsys_unit_<unit>_forward       before the unit's first operation
//     recsys_unit_<unit>_forward_end   after its output
//     recsys_unit_<unit>_backward      when its output gradients have come
//     recsys_unit_<unit>_backward_end  when its input gradients have (the
//                                      bags': when their sparse gradient
//                                      has been made)
//
// for <unit> attention, cross and bags.
//
// A unit mark's name lies outside recsys_mark_, so that a reader that
// splits a replay by the section marks passes over it.
//
// A CUDA graph replay runs no host code, so a host span cannot split a
// replayed step. A kernel launched inside the capture becomes a node of the
// graph, and every replay runs it in its place in the stream's order: in a
// device trace the marks' start times cut the replay into its sections at
// no host cost. Each mark is one block of one thread with no body; its
// device time is the launch's own (about a microsecond). The marks are
// launched only inside a capture.
//
// The kernels are extern "C", so the trace shows them by these names.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC -o libstep_marks.so step_marks.cu

#include <cuda_runtime.h>

extern "C" {

__global__ void recsys_mark_begin() {}
__global__ void recsys_mark_forward() {}
__global__ void recsys_mark_backward() {}
__global__ void recsys_mark_optimizer() {}
__global__ void recsys_mark_end() {}
__global__ void recsys_unit_attention_forward() {}
__global__ void recsys_unit_attention_forward_end() {}
__global__ void recsys_unit_attention_backward() {}
__global__ void recsys_unit_attention_backward_end() {}
__global__ void recsys_unit_cross_forward() {}
__global__ void recsys_unit_cross_forward_end() {}
__global__ void recsys_unit_cross_backward() {}
__global__ void recsys_unit_cross_backward_end() {}
__global__ void recsys_unit_bags_forward() {}
__global__ void recsys_unit_bags_forward_end() {}
__global__ void recsys_unit_bags_backward() {}
__global__ void recsys_unit_bags_backward_end() {}

// Launches mark `which` (0 begin, 1 forward, 2 backward, 3 optimizer,
// 4 end) on `stream`; does not synchronise.
int recsys_mark(int which, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (which) {
    case 0: recsys_mark_begin<<<1, 1, 0, s>>>(); break;
    case 1: recsys_mark_forward<<<1, 1, 0, s>>>(); break;
    case 2: recsys_mark_backward<<<1, 1, 0, s>>>(); break;
    case 3: recsys_mark_optimizer<<<1, 1, 0, s>>>(); break;
    case 4: recsys_mark_end<<<1, 1, 0, s>>>(); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches unit mark `which` (0 attention_forward, 1 attention_forward_end,
// 2 attention_backward, 3 attention_backward_end, then the same four of
// cross, 4-7, and of bags, 8-11) on `stream`; does not synchronise.
int recsys_unit_mark(int which, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (which) {
    case 0: recsys_unit_attention_forward<<<1, 1, 0, s>>>(); break;
    case 1: recsys_unit_attention_forward_end<<<1, 1, 0, s>>>(); break;
    case 2: recsys_unit_attention_backward<<<1, 1, 0, s>>>(); break;
    case 3: recsys_unit_attention_backward_end<<<1, 1, 0, s>>>(); break;
    case 4: recsys_unit_cross_forward<<<1, 1, 0, s>>>(); break;
    case 5: recsys_unit_cross_forward_end<<<1, 1, 0, s>>>(); break;
    case 6: recsys_unit_cross_backward<<<1, 1, 0, s>>>(); break;
    case 7: recsys_unit_cross_backward_end<<<1, 1, 0, s>>>(); break;
    case 8: recsys_unit_bags_forward<<<1, 1, 0, s>>>(); break;
    case 9: recsys_unit_bags_forward_end<<<1, 1, 0, s>>>(); break;
    case 10: recsys_unit_bags_backward<<<1, 1, 0, s>>>(); break;
    case 11: recsys_unit_bags_backward_end<<<1, 1, 0, s>>>(); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
