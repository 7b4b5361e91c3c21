// K1: unmasked candidate depth loop of the match finder.
//
// Replaces the Pallas kernel orz_tpu/ops/match_pallas.py match_depth_pallas
// (_make_kernel(masked=False)), which runs `depth` shift-compare-select rounds
// over (ROWS, 128) VMEM tiles with lane rotations.
//
// Input: every position of B segments sorted by (match key, position), so the
// j-th previous same-key candidate of slot i sits at slot i-j.  For each slot
// i and j = 1..depth (inclusive), candidate i-j is valid when its key equals
// slot i's and ro = rank_s[i]-1-rank_s[i-j] < ro_cap; its LCP is the count of
// equal leading bytes over the 16 payload dwords (64 bytes), capped by the
// fence room and the segment end, and it must reach min_match_len_for_ro(ro).
// Score lcp*1024 + (1023-j); a strictly greater score wins, so ties keep the
// more recent candidate.
//
// Bound on the H100: device-memory bytes.  Each slot reads its own 19 words
// once and, per live candidate, the candidate's key and rank plus as many
// payload dwords as the LCP needs (usually one or two); the arithmetic is a
// few integer operations per byte read.  Design: one thread per sorted slot,
// on a (slot tiles, B) grid.  Neighbouring threads read neighbouring slots
// for the same j, so every candidate load is coalesced across the warp and
// mostly served from L1/L2 (a warp's 32+depth slots span a few lines).
// Because keys are sorted, the first candidate with another key ends the
// loop: most slots stop after a handful of candidates instead of `depth`.
// The slots before slot 0 are the TPU kernel's fill (key -1, never equal to
// a real key, which is >= 0): the loop simply stops at j = i.

#include <cuda_runtime.h>

namespace {

constexpr int kNDw = 16;  // payload dwords per slot (LCP0 / 4)

__global__ void match_depth_kernel(
    const int* __restrict__ msk, const int* __restrict__ msp,
    const int* __restrict__ rank_s, const int* __restrict__ dw_s,
    const int* __restrict__ end, int* __restrict__ best_q,
    int* __restrict__ best_ro, int* __restrict__ best_len, int n, int depth,
    int ro_cap, int fence, int pad_front, int min_len, int gate, int far1,
    int far2) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t row = static_cast<size_t>(b) * n;
  const int* key_r = msk + row;
  const int* pos_r = msp + row;
  const int* rank_r = rank_s + row;
  const int* dw_r = dw_s + static_cast<size_t>(b) * kNDw * n;

  const int key = key_r[i];
  const int p = pos_r[i];
  const int rank = rank_r[i];
  const int e = end[b];
  const int cap = min(fence - ((p - pad_front) & (fence - 1)), e - p);
  unsigned dw[kNDw];
#pragma unroll
  for (int t = 0; t < kNDw; ++t) dw[t] = static_cast<unsigned>(dw_r[t * n + i]);

  int bs = 0, bq = -1, bro = 0, blen = 0;
  const int jmax = min(depth, i);
  for (int j = 1; j <= jmax; ++j) {
    const int c = i - j;
    if (key_r[c] != key) break;  // sorted: every earlier slot differs too
    const int ro = rank - 1 - rank_r[c];
    if (ro >= ro_cap) continue;
    int lcp = 4 * kNDw;
#pragma unroll
    for (int t = 0; t < kNDw; ++t) {
      const unsigned x = dw[t] ^ static_cast<unsigned>(dw_r[t * n + c]);
      if (x != 0u) {
        lcp = 4 * t + ((__ffs(static_cast<int>(x)) - 1) >> 3);
        break;
      }
    }
    lcp = min(lcp, cap);
    const int need = min_len + gate * (ro >= far1) + gate * (ro >= far2);
    if (lcp < need) continue;
    const int score = lcp * 1024 + (1023 - j);
    if (score > bs) {
      bs = score;
      bq = pos_r[c];
      bro = ro;
      blen = lcp;
    }
  }
  best_q[row + i] = bq;
  best_ro[row + i] = bro;
  best_len[row + i] = blen;
}

}  // namespace

extern "C" int otz_match_depth(const int* msk, const int* msp,
                               const int* rank_s, const int* dw_s,
                               const int* end, int* best_q, int* best_ro,
                               int* best_len, int B, int n, int depth,
                               int ro_cap, int fence, int pad_front,
                               int min_len, int gate, int far1, int far2,
                               int n_dw, void* stream) {
  if (n_dw != kNDw) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  dim3 grid((n + threads - 1) / threads, B);
  match_depth_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      msk, msp, rank_s, dw_s, end, best_q, best_ro, best_len, n, depth,
      ro_cap, fence, pad_front, min_len, gate, far1, far2);
  return static_cast<int>(cudaGetLastError());
}
