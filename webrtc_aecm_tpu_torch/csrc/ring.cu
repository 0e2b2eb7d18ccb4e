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

// The batch-major engine's jitter-ring write and read (webrtc_aecm_tpu_torch/
// ops/ring_kernels.py `ring_write`, `ring_read`; plain versions in
// ops/ring_buffer.py `write_plain`, `read_frames_plain`).
//
// ring_write_kernel replaces the TPU kernel ring_write_tpu (webrtc_aecm_tpu/
// ops/pallas_ring.py:379, `_write_kernel` :356) together with the pointer
// arithmetic of ring_buffer.write around it (ring_buffer.py:157-168).
// ring_read_kernel replaces ring_gather_tpu (:56, `_gather_kernel` :36)
// together with ring_buffer.read (:188-200), the read's own move_read_ptr
// (:171-185) and the have-data test of control.process, for every 80-sample
// frame of one Process call.
//
// Bound: the launch, not the bytes.  A call moves 80 or 160 samples per
// stream out of a 4000-sample ring row, about a megabyte at 4096 streams,
// which the card's memory moves in about a microsecond; no single launch
// can take less than the empty kernel aecm_noop does.  The TPU kernels were
// data passes only, because a custom_vmap rule can replace nothing else,
// and a dozen small XLA ops per call did the per-stream pointer arithmetic
// around them.  Here each kernel runs the whole per-stream state machine
// (available_read, the clamp, the wrap rule of the pointers, the zeroing
// past the readable count, have_data) beside its data pass, and the read
// serves all frames of a Process call, so a 10 ms chunk costs one write
// launch and one read launch and no launch of pointer glue around them.
//
// The ring is written in place.  The new pointers go to fresh outputs,
// never over the inputs: every thread of a stream reads the old pointers,
// so no thread may overwrite them, and the caller's old state stays whole.
//
// One warp serves one stream: the lanes read the stream's pointers once (a
// broadcast load), run the state machine in registers and walk the samples
// 32 at a time, three loads in flight per lane; one modulo per lane, none
// per sample.  One thread per sample (every thread redoing its stream's
// state machine, with an integer division to find its stream) took 1.6x
// the device time in the write and 2.1x in the read at 4096 streams on an
// H100 (PERF.md has the times).

constexpr int SAME_WRAP = 0;
constexpr int DIFF_WRAP = 1;

// WebRtc_available_read (ring_buffer.c:213-223).
__device__ __forceinline__ int available_read(int rp, int wp, int wrap,
                                              int C) {
  return wrap == SAME_WRAP ? wp - rp : C - rp + wp;
}

// pos mod C in [0, C): a position may rest at C (ring_buffer.c:196).
__device__ __forceinline__ int wrap_pos(int pos, int C) {
  int p = pos % C;
  return p < 0 ? p + C : p;
}

// WebRtc_WriteBuffer's count and new pointers (ring_buffer.c:142-174).
struct WritePlan {
  int n_write, write_pos, rw_wrap;
};

__device__ __forceinline__ WritePlan plan_write(int rp, int wp, int wrap,
                                                int C, int n) {
  WritePlan w;
  w.n_write = min(C - available_read(rp, wp, wrap, C), n);
  const int margin = C - wp;
  if (w.n_write > margin) {
    w.write_pos = w.n_write - margin;
    w.rw_wrap = DIFF_WRAP;
  } else {
    w.write_pos = wp + w.n_write;  // may rest at C
    w.rw_wrap = wrap;
  }
  return w;
}

// One frame of the read: the readable count, have_data, and the read's own
// WebRtc_MoveReadPtr (ring_buffer.c:176-211) where it applies.  Returns the
// number of samples to emit from the ring (the rest of the frame is zero)
// and the position they start at; advances rp / wrap.
struct ReadFrame {
  int n_read, start, have;
};

__device__ __forceinline__ ReadFrame step_read(int& rp, int& wrap, int wp,
                                               int C, int count, int gate,
                                               int whole_frames) {
  ReadFrame r;
  const int avail = available_read(rp, wp, wrap, C);
  r.have = (avail >= count) && gate;  // floor(avail / count) > 0, gated
  r.n_read = min(avail, count);
  r.start = wrap_pos(rp, C);
  if (whole_frames ? r.have : gate) {
    const int ec = max(min(r.n_read, avail), -(C - avail));
    rp += ec;
    if (rp > C) {
      rp -= C;
      wrap = SAME_WRAP;
    }
    if (rp < 0) {
      rp += C;
      wrap = DIFF_WRAP;
    }
  }
  return r;
}

__global__ void ring_write_kernel(
    int16_t* __restrict__ data, const int* __restrict__ read_pos,
    const int* __restrict__ write_pos, const int* __restrict__ rw_wrap,
    const int* __restrict__ values, long values_stride,
    int* __restrict__ new_write_pos, int* __restrict__ new_rw_wrap, int B,
    int C, int n) {
  const int b = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (b >= B) return;  // the whole warp leaves together
  const int wp = write_pos[b];
  const WritePlan w = plan_write(read_pos[b], wp, rw_wrap[b], C, n);
  int16_t* row = data + (size_t)b * C;
  const int* vrow = values + (size_t)b * values_stride;
  const int start = wrap_pos(wp, C);
  // three loads in flight per lane before the first store
  for (int j0 = lane; j0 < w.n_write; j0 += 3 * 32) {
    int v[3];
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const int j = j0 + 32 * u;
      v[u] = j < w.n_write ? vrow[j] : 0;
    }
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const int j = j0 + 32 * u;
      int idx = start + j;
      if (idx >= C) idx -= C;
      if (j < w.n_write) row[idx] = (int16_t)v[u];  // the C store's wrap
    }
  }
  if (lane == 0) {
    new_write_pos[b] = w.write_pos;
    new_rw_wrap[b] = w.rw_wrap;
  }
}

__global__ void ring_read_kernel(
    const int16_t* __restrict__ data, const int* __restrict__ read_pos,
    const int* __restrict__ write_pos, const int* __restrict__ rw_wrap,
    const bool* __restrict__ gate, int* __restrict__ frames,
    bool* __restrict__ have_data, int* __restrict__ new_read_pos,
    int* __restrict__ new_rw_wrap, int B, int C, int count, int n_frames,
    int whole_frames) {
  const int b = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (b >= B) return;  // the whole warp leaves together
  int rp = read_pos[b], wrap = rw_wrap[b];
  const int wp = write_pos[b];
  const int g = gate ? (int)gate[b] : 1;
  const int16_t* row = data + (size_t)b * C;
  int* out = frames + (size_t)b * n_frames * count;
  for (int f = 0; f < n_frames; ++f) {
    const ReadFrame r = step_read(rp, wrap, wp, C, count, g, whole_frames);
    // three loads in flight per lane before the first store
    for (int j0 = lane; j0 < count; j0 += 3 * 32) {
      int v[3];
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        const int j = j0 + 32 * u;
        int idx = r.start + j;
        if (idx >= C) idx -= C;
        v[u] = j < r.n_read ? (int)row[idx] : 0;  // n_read <= count <= C
      }
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        const int j = j0 + 32 * u;
        if (j < count) out[f * count + j] = v[u];
      }
    }
    if (lane == 0) have_data[(size_t)b * n_frames + f] = r.have != 0;
  }
  if (lane == 0) {
    new_read_pos[b] = rp;
    new_rw_wrap[b] = wrap;
  }
}

__global__ void noop_kernel() {}

constexpr int WARP_THREADS = 128;  // 4 streams (warps) per block

int warp_blocks(int B) { return (B * 32 + WARP_THREADS - 1) / WARP_THREADS; }

}  // namespace

// The least a launch through this binding can cost: an empty kernel, one
// block of one thread (chip_smoke.py's launch floor).
extern "C" int aecm_noop(void* stream) {
  noop_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// data (B, C) int16, written in place; read_pos / write_pos / rw_wrap (B,)
// int32; values (B, n) int32 with unit inner stride and values_stride
// elements between rows; new_write_pos / new_rw_wrap (B,) int32 outputs.
extern "C" int aecm_ring_write(void* data, const void* read_pos,
                               const void* write_pos, const void* rw_wrap,
                               const void* values, long values_stride,
                               void* new_write_pos, void* new_rw_wrap, int B,
                               int C, int n, void* stream) {
  if (B <= 0 || C <= 0 || n <= 0 || n > C || values_stride < n) return -1;
  ring_write_kernel<<<warp_blocks(B), WARP_THREADS, 0, (cudaStream_t)stream>>>(
      (int16_t*)data, (const int*)read_pos, (const int*)write_pos,
      (const int*)rw_wrap, (const int*)values, values_stride,
      (int*)new_write_pos, (int*)new_rw_wrap, B, C, n);
  return (int)cudaGetLastError();
}

// data (B, C) int16; read_pos / write_pos / rw_wrap (B,) int32; gate (B,)
// bool or null (all true); outputs frames (B, n_frames, count) int32,
// have_data (B, n_frames) bool, new_read_pos / new_rw_wrap (B,) int32.
// whole_frames != 0: the read pointer advances only where have_data
// (WebRtcAecm_Process); 0: wherever the gate is true (WebRtc_ReadBuffer).
extern "C" int aecm_ring_read(const void* data, const void* read_pos,
                              const void* write_pos, const void* rw_wrap,
                              const void* gate, void* frames, void* have_data,
                              void* new_read_pos, void* new_rw_wrap, int B,
                              int C, int count, int n_frames,
                              int whole_frames, void* stream) {
  if (B <= 0 || C <= 0 || count <= 0 || count > C || n_frames <= 0) return -1;
  ring_read_kernel<<<warp_blocks(B), WARP_THREADS, 0, (cudaStream_t)stream>>>(
      (const int16_t*)data, (const int*)read_pos, (const int*)write_pos,
      (const int*)rw_wrap, (const bool*)gate, (int*)frames, (bool*)have_data,
      (int*)new_read_pos, (int*)new_rw_wrap, B, C, count, n_frames,
      whole_frames);
  return (int)cudaGetLastError();
}

extern "C" int aecm_ring_multi_pass(void* data, const void* wpos,
                                    const void* n_write, const void* rpos,
                                    const void* values, void* gathered,
                                    int B, int C, int cps, int n,
                                    void* stream) {
  if (B <= 0 || C <= 0 || cps <= 0 || n <= 0) return -1;
  ring_multi_pass_kernel<<<warp_blocks(B), WARP_THREADS, 0,
                           (cudaStream_t)stream>>>(
      (int16_t*)data, (const int*)wpos, (const int*)n_write,
      (const int*)rpos, (const int*)values, (int*)gathered, B, C, cps, n);
  return (int)cudaGetLastError();
}

extern "C" const char* aecm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
