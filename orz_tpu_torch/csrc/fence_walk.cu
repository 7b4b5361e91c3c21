// K3 and K4: the fence-block item walk.
//
// Replaces the Pallas kernels of orz_tpu/ops/walk_pallas.py: K3
// walk_items_pallas (_call with _rec_kernel over _walk_body) and K4
// walk_mask_pallas (_mask_kernel), whose output this kernel's mask is; both
// wrappers (kernels/fence_walk.py, kernels/walk_mask.py) launch this entry
// point.  Inside each FENCE-position block of a segment, the walk follows
// next(p) = p + len(p) from the block base: jumps are clipped to [1, FENCE]
// relative to the base and every step advances at least one position.
// Every visited position is an item start.
//
// On the TPU the walk advanced 128 blocks per vector step with a one-hot
// compare-extract over a (FENCE, 128) VMEM tile, then the REC records were
// sorted per segment.  Bound on the H100: the latency of dependent loads.
// One block walks up to FENCE = 4096 steps, each a load whose address comes
// from the previous load.  Design: one thread per FENCE block
// (B * ceil(cap / FENCE) threads), so every chain runs at its own pace and
// thousands of chains are in flight to hide the latency.  The kernel writes
// the item-start mask in position order (the caller zeroes it); compacting
// that mask in position order yields exactly the sorted starts of the REC
// kernel, so no per-segment sort is needed, and the mask itself is the MASK
// kernel's output.

#include <cuda_runtime.h>

namespace {

__global__ void fence_walk_kernel(const int* __restrict__ nxt,
                                  const int* __restrict__ end,
                                  unsigned char* __restrict__ mask, int B,
                                  int n, int n_blocks, int fence,
                                  int pad_front) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * n_blocks) return;
  const int b = t / n_blocks;
  const int k = t - b * n_blocks;
  const int* row = nxt + static_cast<size_t>(b) * n;
  unsigned char* mrow = mask + static_cast<size_t>(b) * n;
  const int base = pad_front + k * fence;
  const int blk_end = min(max(end[b] - base, 0), fence);
  int cur = 0;
  while (cur < blk_end) {
    mrow[base + cur] = 1;
    const int local = min(max(row[base + cur] - base, 1), fence);
    cur = max(local, cur + 1);
  }
}

}  // namespace

extern "C" int otz_fence_walk(const int* nxt, const int* end,
                              unsigned char* mask, int B, int n, int n_blocks,
                              int fence, int pad_front, void* stream) {
  const int threads = 128;
  const int total = B * n_blocks;
  fence_walk_kernel<<<(total + threads - 1) / threads, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      nxt, end, mask, B, n, n_blocks, fence, pad_front);
  return static_cast<int>(cudaGetLastError());
}
