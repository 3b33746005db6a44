// Stage markers of the chunk programs: one empty kernel per model stage,
// launched on the caller's stream at the start of the stage
// (utils/profiling.py:stage).  Launched on the capture stream, a marker is
// captured into the program's CUDA graph and runs at every replay, so a
// device trace orders the program's kernels by stage: every kernel between
// the marker of one stage and the next marker belongs to that stage.  The
// stage shows in the kernel's name, psfr_stage<stage::psd> and so on.  A
// marker reads and writes nothing: one block of one thread that returns.
//
// The ids are the order of utils/profiling.py:STAGES.

#include <cuda_runtime.h>

namespace stage {
struct psd;
struct otf;
struct conv;
struct fit;
struct reduce;
struct end;
}  // namespace stage

template <class Stage>
__global__ void psfr_stage() {}

extern "C" int muse_stage_mark(int id, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (id) {
    case 0: psfr_stage<stage::psd><<<1, 1, 0, s>>>(); break;
    case 1: psfr_stage<stage::otf><<<1, 1, 0, s>>>(); break;
    case 2: psfr_stage<stage::conv><<<1, 1, 0, s>>>(); break;
    case 3: psfr_stage<stage::fit><<<1, 1, 0, s>>>(); break;
    case 4: psfr_stage<stage::reduce><<<1, 1, 0, s>>>(); break;
    case 5: psfr_stage<stage::end><<<1, 1, 0, s>>>(); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
