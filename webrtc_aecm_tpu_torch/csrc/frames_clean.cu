// The frames kernel's clean-input instances (the device code is in
// frames.cuh; frames.cu holds the C entry points, which call these).
#include "frames.cuh"

namespace aecm {

int frames_launch_clean(bool circular, bool general, const Leaves& lv,
                        Inputs in, cudaStream_t stream) {
  return launch_frames_of<true>(circular, general, lv, in, stream);
}

int frames_layout_clean(bool circular, bool general, int H, int cap,
                        int* streams_per_block, int* smem_bytes,
                        int* blocks_per_sm) {
  return frames_layout_of<true>(circular, general, H, cap, streams_per_block,
                                smem_bytes, blocks_per_sm);
}

}  // namespace aecm
