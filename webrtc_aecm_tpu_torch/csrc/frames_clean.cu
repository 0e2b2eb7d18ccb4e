// The frames kernel's clean-input instances (the device code is in
// frames.cuh; frames.cu holds the C entry points, which call these).
#include "frames.cuh"

namespace aecm {

int frames_launch_clean(bool circular, const Leaves& lv, const Inputs& in,
                        cudaStream_t stream) {
  return circular ? launch_frames<true, true>(lv, in, stream)
                  : launch_frames<true, false>(lv, in, stream);
}

int frames_layout_clean(bool circular, int* streams_per_block,
                        int* smem_bytes, int* blocks_per_sm) {
  return circular ? frames_layout_of<true, true>(streams_per_block,
                                                 smem_bytes, blocks_per_sm)
                  : frames_layout_of<true, false>(streams_per_block,
                                                  smem_bytes, blocks_per_sm);
}

}  // namespace aecm
