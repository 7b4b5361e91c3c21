// P1: the windowed gather.
//
// Replaces the Pallas kernel of tools/gather_probe.py, windowed_gather
// (_wgather_kernel).  For output block b of BLK = 2048 indices, the TPU
// kernel DMA'd the WIN = 8192 int32s of src that start at row
// base[b] / 128 (of 128 words) into VMEM, clamped so that the window ends
// inside src, and gathered from there with jnp.take(fill_value=0):
//
//   row0  = floor(base[b] / 128)
//   start = clamp(row0, 0, n / 128 - WIN / 128) * 128
//   rel   = idx[i] - row0 * 128               (unclamped origin)
//   rel  += WIN   when -WIN <= rel < 0        (negative indices wrap)
//   out[i] = 0 <= rel < WIN ? src[start + rel] : 0
//
// Bound on the H100: bytes.  Each output does a handful of integer
// operations; what must move is idx (read), out (written) and the src
// words the indices reach.  Design: one CTA per output block, which reads
// its base once per thread (a broadcast load) and computes the window
// start from it, and one thread per output, 8 outputs a thread at a
// stride of 256 so that the idx loads and the out stores are coalesced.
// The window is NOT staged in shared memory, as the TPU kernel staged it
// in VMEM: staging reads all WIN words of every window, 4x the outputs,
// while the caller's indices are ascending and dense (about one in three
// words at the probe's strides), so direct loads of a warp fall in a few
// neighbouring 32-byte sectors and move only the sectors the indices
// reach, through L1 and L2.

#include <cuda_runtime.h>

namespace {

constexpr int kBlk = 2048;
constexpr int kWin = 4 * kBlk;
constexpr int kThreads = 256;

__global__ void windowed_gather_kernel(const int* __restrict__ src,
                                       const int* __restrict__ idx,
                                       const int* __restrict__ base,
                                       int* __restrict__ out, int n) {
  const int row0 = base[blockIdx.x] >> 7;  // floor division by 128
  const int start = min(max(row0, 0), n / 128 - kWin / 128) * 128;
  // int32 arithmetic that wraps, as the TPU kernel's
  const unsigned origin = static_cast<unsigned>(row0) * 128u;
  const size_t off = static_cast<size_t>(blockIdx.x) * kBlk;
  for (int k = threadIdx.x; k < kBlk; k += kThreads) {
    int rel = static_cast<int>(static_cast<unsigned>(idx[off + k]) - origin);
    if (rel < 0 && rel >= -kWin) rel += kWin;
    out[off + k] = (rel >= 0 && rel < kWin) ? src[start + rel] : 0;
  }
}

}  // namespace

extern "C" int otz_windowed_gather(const int* src, const int* idx,
                                   const int* base, int* out, int n,
                                   int n_blocks, void* stream) {
  windowed_gather_kernel<<<n_blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      src, idx, base, out, n);
  return static_cast<int>(cudaGetLastError());
}
