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
// compare-extract over a (FENCE, 128) VMEM tile.  On the H100 a chain of
// up to FENCE dependent steps is a chain of latencies: one thread per block
// walking device memory paid a scattered load and a byte store a step,
// about 480 cycles.  Design: one warp per block, kBlocks blocks a CTA.
//  1. Stage: the warp reads its block's nxt with coalesced 16-byte loads
//     (never past column n - 1, nor past the segment end) and keeps the
//     local jumps in shared memory as uint16 (1..FENCE), 8 KiB a block.
//  2. Speculate: lane l owns the chunk [128 l, 128 l + 128) and walks it
//     from its first position, setting bits in a shared bit mask; it keeps
//     its exit, the first position past the chunk.
//  3. Fix up, lane by lane: the true entry of chunk l is chunk l-1's true
//     exit.  Past the chunk: the chunk has no starts.  At the chunk's first
//     position: the speculation was exact.  Otherwise lane l walks from the
//     entry, setting bits in a second mask, until it reaches a position the
//     speculation visited (the merge point m) or leaves the chunk.  The
//     walk from a position is deterministic, so from m on the two walks
//     coincide, and a speculative mark below m is false (were it on the
//     true path, the walks would have merged there).  The chunk's marks are
//     the fix-up marks below m and the speculative marks from m on; this is
//     exact on every input, and only the fix-ups' length depends on it.
//  4. Write: the warp writes every mask byte of its block, coalesced, 16
//     at a time, zeros past the segment end included; the CTA of a row's
//     first block also writes the PAD_FRONT head, so the caller need not
//     zero the mask.  With `counts`, the block's popcount is added to its
//     segment's count (one atomicAdd a block).
// Every walk keeps the 32-bit word of bits it is in in a register and
// stores it when it leaves the word: positions only grow along a walk.
// The design measured against this one, one lane walking the whole staged
// block, took twice as long.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFence = 4096;              // positions a block (FENCE)
constexpr int kChunk = kFence / 32;       // positions a lane's chunk
constexpr int kWords = kFence / 32;       // bit-mask words a block
constexpr int kBlocks = 4;                // blocks (warps) a CTA
constexpr unsigned kFull = 0xffffffffu;

struct alignas(16) BlockSmem {
  uint16_t jump[kFence];  // local jump of each position below blk_end
  unsigned spec[kWords];  // speculative marks; the final mask after step 3
  unsigned fix[kWords];   // fix-up marks
};

// Walk from `cur` while cur < stop, marking bits; returns the exit.  With
// `merge`, stop before a position whose bit is set in `merge`.
template <bool kMerge>
__device__ __forceinline__ int walk(const uint16_t* jump, unsigned* bits,
                                    const unsigned* merge, int cur,
                                    int stop) {
  int w = cur >> 5;
  unsigned acc = 0u;
  while (cur < stop) {
    if (kMerge && ((merge[cur >> 5] >> (cur & 31)) & 1u)) break;
    if ((cur >> 5) != w) {
      bits[w] = acc;
      w = cur >> 5;
      acc = 0u;
    }
    acc |= 1u << (cur & 31);
    cur = max(static_cast<int>(jump[cur]), cur + 1);
  }
  if (acc) bits[w] = acc;
  return cur;
}

__device__ __forceinline__ unsigned low_bits(int k) {  // bits below k
  return k <= 0 ? 0u : k >= 32 ? kFull : (1u << k) - 1u;
}

// Steps 2-3 for one warp's block: the block's marks into s.spec.
__device__ __forceinline__ void chunked_walk(BlockSmem& s, int lane,
                                             int blk_end) {
  // 2. speculate: lane l from its chunk's first position
  const int c0 = lane * kChunk;
  const int c_end = min(c0 + kChunk, blk_end);
  const int spec_exit = walk<false>(s.jump, s.spec, nullptr, c0, c_end);
  __syncwarp();
  // 3. fix up in lane order; lane l keeps its merge point m
  int entry = 0, m = c0;
  for (int l = 0; l < 32; ++l) {
    int out = 0;
    if (lane == l) {
      if (entry >= c_end) {  // a jump over the whole chunk
        m = c0 + kChunk;
        out = entry;
      } else if (entry == c0) {  // the speculation was exact
        out = spec_exit;
      } else {
        const int cur = walk<true>(s.jump, s.fix, s.spec, entry, c_end);
        m = cur < c_end ? cur : c0 + kChunk;
        out = cur < c_end ? spec_exit : cur;
      }
    }
    entry = __shfl_sync(kFull, out, l);
  }
  // the chunk's marks: fix-up below m, speculative from m on
#pragma unroll
  for (int w = 0; w < kChunk / 32; ++w) {
    const int i = lane * (kChunk / 32) + w;
    const unsigned lo = low_bits(m - 32 * i);
    s.spec[i] = (s.fix[i] & lo) | (s.spec[i] & ~lo);
  }
}

__global__ void __launch_bounds__(32 * kBlocks)
    fence_walk_kernel(const int* __restrict__ nxt, const int* __restrict__ end,
                      unsigned char* __restrict__ mask, int* __restrict__ counts,
                      int B, int n, int n_blocks, int pad_front) {
  __shared__ BlockSmem smem[kBlocks];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = blockIdx.x * kBlocks + warp;  // the warp's block
  if (g >= B * n_blocks) return;              // (no CTA-wide barrier below)
  BlockSmem& s = smem[warp];
  const int b = g / n_blocks, k = g - b * n_blocks;
  const size_t row = static_cast<size_t>(b) * n;
  const int base = pad_front + k * kFence;
  const int width = min(kFence, n - base);  // mask bytes of the block
  const int blk_end = min(min(max(end[b] - base, 0), kFence), width);

  // 1. stage the local jumps of [0, blk_end)
  const int* src = nxt + row + base;
  const bool vec = (reinterpret_cast<uintptr_t>(src) & 15u) == 0u;
  const int n4 = vec ? blk_end >> 2 : 0;
#pragma unroll 8
  for (int q = lane; q < n4; q += 32) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(src) + q);
    const uint2 packed = make_uint2(
        static_cast<unsigned>(min(max(v.x - base, 1), kFence)) |
            static_cast<unsigned>(min(max(v.y - base, 1), kFence)) << 16,
        static_cast<unsigned>(min(max(v.z - base, 1), kFence)) |
            static_cast<unsigned>(min(max(v.w - base, 1), kFence)) << 16);
    reinterpret_cast<uint2*>(s.jump)[q] = packed;
  }
  for (int p = 4 * n4 + lane; p < blk_end; p += 32)
    s.jump[p] = static_cast<uint16_t>(min(max(__ldg(src + p) - base, 1),
                                          kFence));
#pragma unroll
  for (int w = 0; w < kWords / 32; ++w) {
    s.spec[lane + 32 * w] = 0u;
    s.fix[lane + 32 * w] = 0u;
  }
  __syncwarp();

  chunked_walk(s, lane, blk_end);  // 2-3
  __syncwarp();

  // 4. write every mask byte of the block, 16 at a time
  unsigned char* dst = mask + row + base;
  int cnt = 0;
#pragma unroll
  for (int w = 0; w < kWords / 32; ++w) cnt += __popc(s.spec[lane + 32 * w]);
  const bool vec_out = (reinterpret_cast<uintptr_t>(dst) & 15u) == 0u;
  for (int h = lane; h < 2 * kWords; h += 32) {  // h: 16 positions
    const int p = 16 * h;
    if (p >= width) break;
    const unsigned bits16 = (s.spec[h >> 1] >> (16 * (h & 1))) & 0xffffu;
    unsigned word[4];
#pragma unroll
    for (int t = 0; t < 4; ++t)  // nibble -> 4 bytes of 0/1
      word[t] = (((bits16 >> (4 * t)) & 15u) * 0x00204081u) & 0x01010101u;
    if (vec_out && p + 16 <= width) {
      reinterpret_cast<uint4*>(dst)[h] =
          make_uint4(word[0], word[1], word[2], word[3]);
    } else {
      for (int t = 0; t < 16 && p + t < width; ++t)
        dst[p + t] =
            static_cast<unsigned char>((word[t >> 2] >> (8 * (t & 3))) & 1u);
    }
  }
  if (k == 0)  // the row's PAD_FRONT head
    for (int p = lane; p < pad_front; p += 32) mask[row + p] = 0;
  if (counts != nullptr) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(kFull, cnt, o);
    if (lane == 0 && cnt != 0) atomicAdd(counts + b, cnt);
  }
}

}  // namespace

// counts: null (K3), or a zeroed (B,) int32 that receives each segment's
// item count (K4).  The kernel writes every byte of the (B, n) mask.
extern "C" int otz_fence_walk(const int* nxt, const int* end,
                              unsigned char* mask, int* counts, int B, int n,
                              int n_blocks, int fence, int pad_front,
                              void* stream) {
  if (fence != kFence || B < 1 || n_blocks < 1 ||
      pad_front + n_blocks * kFence < n ||
      pad_front + (n_blocks - 1) * kFence >= n)
    return static_cast<int>(cudaErrorInvalidValue);
  const int total = B * n_blocks;
  fence_walk_kernel<<<(total + kBlocks - 1) / kBlocks, 32 * kBlocks, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      nxt, end, mask, counts, B, n, n_blocks, pad_front);
  return static_cast<int>(cudaGetLastError());
}
