// K1 and K2: the candidate depth loop of the match finder.
//
// Replaces the Pallas kernel orz_tpu/ops/match_pallas.py match_depth_pallas:
// K1 is _make_kernel(masked=False) (FRONT), K2 is _make_kernel(masked=True)
// (the OTZ2 iterations and conform analyses).  The TPU kernel runs `depth`
// shift-compare-select rounds over (ROWS, 128) VMEM tiles with lane
// rotations and a row halo.
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
// K2 (masked) adds, from match_pallas.py:144-175: a candidate must carry mask
// 1 (it was an item start of the previous parse, and rank_s holds masked
// prefix counts); for j > near_depth (when near_depth > 0) the query itself
// must carry mask 1; and with a two-tier cap (ro_cap_near < ro_cap) a
// candidate at ro >= ro_cap_near scores lcp alone, below every near one.
// K1 is the same loop with no mask, near_depth 0 and ro_cap_near = ro_cap.
//
// Bound on the H100: device-memory bytes.  Each slot reads its own 19 words
// once (and its mask byte) and, per live candidate, the candidate's key,
// mask and rank plus as many payload dwords as the LCP needs (usually one or
// two); the arithmetic is a few integer operations per byte read.  Design:
// one thread per sorted slot, on a (slot tiles, B) grid.  Neighbouring
// threads read neighbouring slots for the same j, so every candidate load is
// coalesced across the warp and mostly served from L1/L2 (a warp's 32+depth
// slots span a few lines).  Because keys are sorted, the first candidate
// with another key ends the loop: most slots stop after a handful of
// candidates instead of `depth`.  Long same-key groups (binary runs,
// frequent 4-grams) do walk all 384 shifts of K2; there the mask byte is
// tested before any dword is loaded, and a query without mask 1 stops at
// near_depth instead of testing candidates it may not take.  The slots
// before slot 0 are the TPU kernel's fill (key -1, never equal to a real
// key, which is >= 0): the loop simply stops at j = i.  The inclusive
// j <= depth bound matters at depth 384, a multiple of 128, where the TPU
// kernel once dropped the last shift (match_pallas.py:196-199).

#include <cuda_runtime.h>

namespace {

constexpr int kNDw = 16;  // payload dwords per slot (LCP0 / 4)

template <bool kMasked>
__global__ void match_depth_kernel(
    const int* __restrict__ msk, const int* __restrict__ msp,
    const int* __restrict__ rank_s, const int* __restrict__ dw_s,
    const unsigned char* __restrict__ mask_s, const int* __restrict__ end,
    int* __restrict__ best_q, int* __restrict__ best_ro,
    int* __restrict__ best_len, int n, int depth, int ro_cap, int near_depth,
    int ro_cap_near, int fence, int pad_front, int min_len, int gate,
    int far1, int far2) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t row = static_cast<size_t>(b) * n;
  const int* key_r = msk + row;
  const int* pos_r = msp + row;
  const int* rank_r = rank_s + row;
  const int* dw_r = dw_s + static_cast<size_t>(b) * kNDw * n;
  const unsigned char* mask_r = kMasked ? mask_s + row : nullptr;

  const int key = key_r[i];
  const int p = pos_r[i];
  const int rank = rank_r[i];
  const int e = end[b];
  const int cap = min(fence - ((p - pad_front) & (fence - 1)), e - p);
  unsigned dw[kNDw];
#pragma unroll
  for (int t = 0; t < kNDw; ++t) dw[t] = static_cast<unsigned>(dw_r[t * n + i]);

  int bs = 0, bq = -1, bro = 0, blen = 0;
  int jmax = min(depth, i);
  if (kMasked && near_depth > 0 && mask_r[i] == 0) jmax = min(jmax, near_depth);
  for (int j = 1; j <= jmax; ++j) {
    const int c = i - j;
    if (key_r[c] != key) break;  // sorted: every earlier slot differs too
    if (kMasked && mask_r[c] == 0) continue;
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
    int score = lcp * 1024 + (1023 - j);
    if (kMasked && ro >= ro_cap_near) score = lcp;  // far tier
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

template <bool kMasked>
int launch(const int* msk, const int* msp, const int* rank_s, const int* dw_s,
           const unsigned char* mask_s, const int* end, int* best_q,
           int* best_ro, int* best_len, int B, int n, int depth, int ro_cap,
           int near_depth, int ro_cap_near, int fence, int pad_front,
           int min_len, int gate, int far1, int far2, int n_dw,
           void* stream) {
  if (n_dw != kNDw) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  dim3 grid((n + threads - 1) / threads, B);
  match_depth_kernel<kMasked>
      <<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
          msk, msp, rank_s, dw_s, mask_s, end, best_q, best_ro, best_len, n,
          depth, ro_cap, near_depth, ro_cap_near, fence, pad_front, min_len,
          gate, far1, far2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1 when mask_s is null (near_depth and ro_cap_near are then ignored), K2
// otherwise.
extern "C" int otz_match_depth(
    const int* msk, const int* msp, const int* rank_s, const int* dw_s,
    const unsigned char* mask_s, const int* end, int* best_q, int* best_ro,
    int* best_len, int B, int n, int depth, int ro_cap, int near_depth,
    int ro_cap_near, int fence, int pad_front, int min_len, int gate,
    int far1, int far2, int n_dw, void* stream) {
  if (mask_s == nullptr)
    return launch<false>(msk, msp, rank_s, dw_s, nullptr, end, best_q,
                         best_ro, best_len, B, n, depth, ro_cap, 0, ro_cap,
                         fence, pad_front, min_len, gate, far1, far2, n_dw,
                         stream);
  return launch<true>(msk, msp, rank_s, dw_s, mask_s, end, best_q, best_ro,
                      best_len, B, n, depth, ro_cap, near_depth, ro_cap_near,
                      fence, pad_front, min_len, gate, far1, far2, n_dw,
                      stream);
}
