// The frames kernel's single-input instances and its C entry points (the
// device code is in frames.cuh; frames_clean.cu builds the clean-input
// instances).
#include "frames.cuh"

extern "C" int aecm_frames_step(void* const* leaves, int n_leaves,
                                const void* far, const void* noisy,
                                const void* clean, const void* lcg_a,
                                const void* lcg_c, const void* cos360,
                                const void* sin360, const void* run_rows,
                                const void* win128,
                                const void* fwr, const void* fws, void* out,
                                void* pend_hist, void* pend_q,
                                const void* head, int B, int mult, int fpc,
                                int n_frames,
                                int has_clean, int abs_approx, int H,
                                int cap, void* stream) {
  using namespace aecm;
  if (n_leaves != N_LEAVES) return -1;
  // head (a device int in [0, MAX_DELAY)): the circular history, whose
  // step is whole blocks dividing the history; null: the newest-first
  // history, any frame count
  const bool circular = head != nullptr;
  const int span = n_frames * FRAME_LEN;
  if (B <= 0 || fpc <= 0 || n_frames < 1 ||
      n_frames % fpc != 0 || H <= 1 || cap < 1 ||
      (circular && (span % PART_LEN != 0 ||
                    MAX_DELAY % (span / PART_LEN) != 0))) {
    return -2;
  }
  const bool general = frames_instance_is_general(H, cap, n_frames, circular);
  if ((has_clean && clean == nullptr) || lcg_a == nullptr ||
      lcg_c == nullptr || cos360 == nullptr || sin360 == nullptr ||
      ((circular || general) && (pend_hist == nullptr || pend_q == nullptr))) {
    return -3;
  }
  Leaves lv;
  for (int i = 0; i < N_LEAVES; ++i) lv.p[i] = leaves[i];
  Inputs in{(const int*)far,         (const int*)noisy,
            (const int*)clean,       (const long long*)lcg_a,
            (const long long*)lcg_c, (const int*)cos360,
            (const int*)sin360,      (const bool*)run_rows,
            (const int*)win128,      (const int*)fwr,
            (const int*)fws,         (int*)out,
            (int*)pend_hist,         (int*)pend_q,
            (const int*)head,        B,
            mult,                    fpc,
            n_frames,                abs_approx != 0,
            Geo{H, cap},             0};
  const cudaStream_t s = (cudaStream_t)stream;
  if (has_clean) return frames_launch_clean(circular, general, lv, in, s);
  return launch_frames_of<false>(circular, general, lv, in, s);
}

// The launch shape a step of these dimensions takes, for reports: streams
// per block, shared bytes per block, and how many blocks of it an SM holds
// at once.
extern "C" int aecm_frames_layout(int has_clean, int circular, int H, int cap,
                                  int n_frames, int* streams_per_block,
                                  int* smem_bytes, int* blocks_per_sm) {
  using namespace aecm;
  const bool general =
      frames_instance_is_general(H, cap, n_frames, circular != 0);
  if (has_clean) {
    return frames_layout_clean(circular != 0, general, H, cap,
                               streams_per_block, smem_bytes, blocks_per_sm);
  }
  return frames_layout_of<false>(circular != 0, general, H, cap,
                                 streams_per_block, smem_bytes,
                                 blocks_per_sm);
}
