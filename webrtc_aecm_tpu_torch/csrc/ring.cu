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

// The batch-major engine's two passes (webrtc_aecm_tpu_torch/ops/
// ring_kernels.py `ring_gather`, `ring_write`).
//
// ring_gather_kernel replaces the TPU kernel ring_gather_tpu
// (webrtc_aecm_tpu/ops/pallas_ring.py:56, `_gather_kernel` :36);
// ring_write_kernel replaces ring_write_tpu (:379, `_write_kernel` :356).
// Plain versions: webrtc_aecm_tpu_torch/ops/ring_buffer.py `_contig_read`
// and `_contig_write`.
//
// Bound: launch and memory latency.  A call moves n samples per stream
// (n = 80 or 160) out of a 4000-sample ring row: a few hundred bytes per
// stream, about a megabyte at 4096 streams, so the bandwidth time is under
// a microsecond.  The TPU kernels streamed whole 8 KB ring rows through
// VMEM and rotated them with pltpu.roll; here one thread handles one
// sample, so a warp's lanes touch consecutive samples of a row (one or two
// row segments, split only where the ring wraps), and nothing else of the
// row is read or written.  The write is in place.

__global__ void ring_gather_kernel(const int16_t* __restrict__ data,
                                   const int* __restrict__ pos,
                                   int16_t* __restrict__ out, int B, int C,
                                   int n) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)B * n) return;
  const int b = (int)(i / n);
  const int j = (int)(i - (long)b * n);
  int idx = (pos[b] + j) % C;
  if (idx < 0) idx += C;
  out[i] = data[(size_t)b * C + idx];
}

__global__ void ring_write_kernel(int16_t* __restrict__ data,
                                  const int* __restrict__ pos,
                                  const int* __restrict__ n_write,
                                  const int* __restrict__ values, int B,
                                  int C, int n) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)B * n) return;
  const int b = (int)(i / n);
  const int j = (int)(i - (long)b * n);
  if (j >= n_write[b]) return;
  int idx = (pos[b] + j) % C;
  if (idx < 0) idx += C;
  data[(size_t)b * C + idx] = (int16_t)values[i];  // the C store's wrap
}

int blocks_for(long items, int threads) {
  return (int)((items + threads - 1) / threads);
}

}  // namespace

extern "C" int aecm_ring_gather(const void* data, const void* pos, void* out,
                                int B, int C, int n, void* stream) {
  if (B <= 0 || C <= 0 || n <= 0) return -1;
  const int threads = 256;
  ring_gather_kernel<<<blocks_for((long)B * n, threads), threads, 0,
                       (cudaStream_t)stream>>>(
      (const int16_t*)data, (const int*)pos, (int16_t*)out, B, C, n);
  return (int)cudaGetLastError();
}

extern "C" int aecm_ring_write(void* data, const void* pos,
                               const void* n_write, const void* values, int B,
                               int C, int n, void* stream) {
  if (B <= 0 || C <= 0 || n <= 0 || n > C) return -1;
  const int threads = 256;
  ring_write_kernel<<<blocks_for((long)B * n, threads), threads, 0,
                      (cudaStream_t)stream>>>(
      (int16_t*)data, (const int*)pos, (const int*)n_write,
      (const int*)values, B, C, n);
  return (int)cudaGetLastError();
}

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
