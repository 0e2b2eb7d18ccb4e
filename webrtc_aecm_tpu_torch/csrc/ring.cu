// The jitter-ring data pass of the fused serving step, for Hopper (sm_90a).
//
// Replaces the TPU kernels ring_multi_pass_tpu (webrtc_aecm_tpu/ops/
// pallas_ring.py:306) and ring_pass_tpu (:169): cps is a runtime argument,
// so cps = 1 is the one-chunk pass.  Plain version:
// webrtc_aecm_tpu_torch/fused.py `_ring_write_gather_multi`.
//
// Per stream, for c = 0..cps-1: write values[c*n : c*n + n_write[c]] at
// [wpos[c], ...) mod C into the int16 ring row, then gather n samples at
// [rpos[c], ...) mod C.  Chunk c's gather sees writes 0..c only.  The ring
// is updated in place.
//
// Bound: memory latency.  One warp serves one stream and touches only the
// samples it writes and reads (at most cps*n of each), never the whole
// ring row; the warp's lanes hit consecutive samples of the row.  Streams
// with clamped (partial) writes need no special path: every stream runs its
// own positions, which is what the TPU kernel's uniform/divergent split and
// replay emulated.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void ring_multi_pass_kernel(int16_t* __restrict__ data,
                                       const int* __restrict__ wpos,
                                       const int* __restrict__ n_write,
                                       const int* __restrict__ rpos,
                                       const int* __restrict__ values,
                                       int* __restrict__ gathered, int B,
                                       int C, int cps, int n) {
  const int stream = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (stream >= B) return;  // the whole warp leaves together
  int16_t* row = data + (size_t)stream * C;
  const int* vrow = values + (size_t)stream * cps * n;
  int* grow = gathered + (size_t)stream * cps * n;
  for (int c = 0; c < cps; ++c) {
    const int p = wpos[c * B + stream];
    const int w = min(n_write[c * B + stream], n);
    const int r = rpos[c * B + stream];
    for (int j = lane; j < w; j += 32) {
      int idx = (p + j) % C;
      if (idx < 0) idx += C;
      row[idx] = (int16_t)vrow[c * n + j];
    }
    __syncwarp();  // this chunk's writes are visible to its gather
    for (int j = lane; j < n; j += 32) {
      int idx = (r + j) % C;
      if (idx < 0) idx += C;
      grow[c * n + j] = (int)row[idx];
    }
    __syncwarp();  // the gather is done before the next chunk's write
  }
}

}  // namespace

extern "C" int aecm_ring_multi_pass(void* data, const void* wpos,
                                    const void* n_write, const void* rpos,
                                    const void* values, void* gathered,
                                    int B, int C, int cps, int n,
                                    void* stream) {
  if (B <= 0 || C <= 0 || cps <= 0 || n <= 0) return -1;
  const int threads = 128;  // 4 streams per block
  const int blocks = (B * 32 + threads - 1) / threads;
  ring_multi_pass_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (int16_t*)data, (const int*)wpos, (const int*)n_write,
      (const int*)rpos, (const int*)values, (int*)gathered, B, C, cps, n);
  return (int)cudaGetLastError();
}

extern "C" const char* aecm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
