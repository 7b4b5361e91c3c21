// The segmented scans over sorted slots of QUALITY, MID2's repair loop, the
// item merges and FRONT's context ranks.
//
// Replaces no TPU kernel.  The JAX package runs these scans as
// lax.associative_scan or lax.cummax (orz_tpu/ops/batched.py
// _words1_scan_b, masked_context_counts_planned_b, context_ranks_b,
// cand_of_queries, _rep0_b, lengths_and_symbols; orz_tpu/ops/otz2.py
// _pred_at_items_b, _ranks_and_membership_b, _expand_b), which XLA lowers
// itself.  The port first rebuilt them from ATen's torch.cummax and
// torch.cumsum, which give each row of a (B, n) scan one 512-thread CTA:
// 4 of the 132 SMs at B = 4, one at B = 1, about 25 ms an int64 cummax at
// n = 8 MiB + 16.
//
// Four operators over (B, n) rows, into int32 `out`.  `first` (bool: a
// group starts at the slot; a row's first slot starts one whatever its
// flag) may be null: then a row is one group.
//   op 0, last-marked (bool `marked`): the index of the newest marked slot
//     at or before the slot within its group, -1 where there is none
//     (QUALITY's word updates, MID2's word predictions, rep0_b's newest
//     match, the group starts of context_ranks_b and
//     _ranks_and_membership_b);
//   op 1, exclusive count (bool `marked`): the count of marked slots
//     before the slot within its group (QUALITY's context counts);
//   op 2, running max (int32 `values`): the max of the values from the
//     group's start through the slot (the item merges' _seg_cummax and
//     cand_of_queries);
//   op 3, exclusive sum (int32 `values`): the sum of the values before the
//     slot within its group, modulo 2^32 (_expand_b's offsets).
// Bound on the H100: bytes.  Ops 0 and 1 read 2 and write 4 bytes a slot
// (200 MB, 0.06 ms at 3.35 TB/s, at 4 x (8 MiB + 16) slots); ops 2 and 3
// read 1 (with `first`) and 4 and write 4.
//
// Design: one CTA per 4096-slot tile of a row (256 threads x 16 slots, each
// flag row read with one 16-byte load a thread), 8192 tiles at B = 4.  A
// thread scans its 16 slots in registers; the CTA combines the threads'
// states with warp shuffles and one shared-memory pass.  A state (v, r) is
// the operator's value since a run's last group start and whether a group
// starts in the run; a run L followed by a run R combine to
// (R.r ? R.v : op(L.v, R.v), L.r | R.r), op max (0, 2) or + (1, 3).  The
// carry across tiles is a single-pass decoupled look-back: each tile
// publishes its state in one 64-bit descriptor (status, r, v), first as
// its aggregate, then as its inclusive prefix, and warp 0 reads the 32
// descriptors before its tile at a time, stopping at the first that is a
// prefix or holds a group start.  Tiles take their ids from an atomic
// counter in the order their CTAs start, so every tile a look-back waits on
// is running: no deadlock.  The descriptors are cleared on the stream just
// before the launch; the answers are integers, exact in any order.
// At 4 x (8 MiB + 16) the time goes to each CTA's chain of latencies (the
// counter, the loads, the look-back) more than to the bytes (PERF.md
// section 6 has the measurements).  So a thread keeps only its
// flags across the look-back and computes its outputs again afterwards
// (at most 40 registers: 6 CTAs an SM), and a whole tile's outputs go out
// through shared memory, so that a warp store writes 512 contiguous bytes
// and not a 16-byte piece of each of 16 lines.  Ops 2 and 3 bring the
// tile's values into that same shared buffer first, with coalesced loads,
// and keep them there across the look-back: a thread reads its own 16
// values from it twice and overwrites them with its outputs.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 6;              // CTAs an SM: 40 registers
constexpr int kItems = 16;                 // slots a thread
constexpr int kTile = kThreads * kItems;   // slots a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kWords = kItems / 4;         // flag words a thread
constexpr int kVecs = kItems / 16;         // 16-byte loads a flag row
constexpr unsigned kFull = 0xffffffffu;

// descriptor: bits 0-31 v, bit 32 r, bits 33-34 status (0: not yet)
constexpr uint64_t kReset = 1ull << 32;
constexpr uint64_t kAggregate = 1ull << 33;
constexpr uint64_t kPrefix = 2ull << 33;
constexpr uint64_t kStatus = 3ull << 33;

// An operator: its identity, its combine op, and step, the output at one
// slot, which updates the running value v.  Ops 0 and 1 step on a slot's
// mark and index, ops 2 and 3 on its value.
struct LastMarked {
  static constexpr bool kValued = false;
  static constexpr int kIdentity = -1;
  static __device__ __forceinline__ int op(int a, int b) { return max(a, b); }
  // one slot: the output at `slot`, updating the running value
  static __device__ __forceinline__ int step(int& v, bool mk, int slot) {
    if (mk) v = slot;
    return v;
  }
};

struct ExclCount {
  static constexpr bool kValued = false;
  static constexpr int kIdentity = 0;
  static __device__ __forceinline__ int op(int a, int b) { return a + b; }
  static __device__ __forceinline__ int step(int& v, bool mk, int) {
    const int o = v;
    v += mk;
    return o;
  }
};

struct RunningMax {
  static constexpr bool kValued = true;
  static constexpr int kIdentity = INT_MIN;
  static __device__ __forceinline__ int op(int a, int b) { return max(a, b); }
  static __device__ __forceinline__ int step(int& v, int x) {
    v = max(v, x);
    return v;
  }
};

struct ExclSum {  // modulo 2^32: unsigned adds, which may wrap
  static constexpr bool kValued = true;
  static constexpr int kIdentity = 0;
  static __device__ __forceinline__ int op(int a, int b) {
    return static_cast<int>(static_cast<unsigned>(a) +
                            static_cast<unsigned>(b));
  }
  static __device__ __forceinline__ int step(int& v, int x) {
    const int o = v;
    v = op(v, x);
    return o;
  }
};

struct State {
  int v;
  bool r;
};

template <class Op>
__device__ __forceinline__ State cat(State a, State b) {  // a, then b
  return {b.r ? b.v : Op::op(a.v, b.v), a.r || b.r};
}

__device__ __forceinline__ State shfl_up(State s, int d) {
  return {__shfl_up_sync(kFull, s.v, d),
          __shfl_up_sync(kFull, static_cast<int>(s.r), d) != 0};
}

__device__ __forceinline__ uint64_t load_relaxed(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ uint64_t pack(uint64_t status, State s) {
  return status | (s.r ? kReset : 0ull) | static_cast<uint32_t>(s.v);
}

// The tile's outputs in shared memory take 4 words of padding after
// every 32, so that neither a thread's four 16-byte stores of its own
// slots nor a warp's 16-byte loads of 128 neighbouring slots meet in a
// bank.
__device__ __forceinline__ int padded(int s) { return s + 4 * (s >> 5); }

__device__ __forceinline__ bool byte_at(const uint32_t (&w)[kWords], int i) {
  return (w[i >> 2] >> (8 * (i & 3))) & 0xffu;
}

// slot i of a thread's run, whose first slot is t0; x is the slot's value
// (ops 2 and 3), unused by ops 0 and 1
template <class Op>
__device__ __forceinline__ int step_at(int& v, const uint32_t (&mw)[kWords],
                                       int i, int t0, int x) {
  if constexpr (Op::kValued)
    return Op::step(v, x);
  else
    return Op::step(v, byte_at(mw, i), t0 + i);
}

// a thread's kItems flags from p + off as bytes of 0 or 1, 0 past the
// row's end (slot t0 + i < n) and everywhere when p is null
__device__ __forceinline__ void load_flags(const unsigned char* p,
                                           size_t off, int t0, int n,
                                           uint32_t (&w)[kWords]) {
#pragma unroll
  for (int j = 0; j < kWords; ++j) w[j] = 0u;
  if (p == nullptr) return;
  if (t0 + kItems <= n &&
      (reinterpret_cast<uintptr_t>(p + off) & 15u) == 0u) {
#pragma unroll
    for (int q = 0; q < kVecs; ++q) {
      const uint4 f = __ldcs(reinterpret_cast<const uint4*>(p + off) + q);
      w[4 * q] = f.x; w[4 * q + 1] = f.y; w[4 * q + 2] = f.z;
      w[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i)
      if (t0 + i < n)
        w[i >> 2] |= static_cast<uint32_t>(p[off + i] != 0) << (8 * (i & 3));
  }
}

// the values of slots s to s + 3 of the staged tile (ops 2 and 3); zeros
// for ops 0 and 1, which stage no values
template <class Op>
__device__ __forceinline__ int4 values_at(const int* staged, int s) {
  if constexpr (Op::kValued)
    return *reinterpret_cast<const int4*>(staged + padded(s));
  else
    return make_int4(0, 0, 0, 0);
}

template <class Op>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
seg_scan_kernel(const unsigned char* __restrict__ first,
                const unsigned char* __restrict__ marked,
                const int* __restrict__ values, int* __restrict__ out,
                unsigned* counter, uint64_t* desc, int n, int tiles_per_row) {
  __shared__ int warp_v[kWarps];
  __shared__ bool warp_r[kWarps];
  __shared__ int s_tile, s_prefix;
  __shared__ bool s_head_first;
  __shared__ __align__(16) int staged[kTile + kTile / 8];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = static_cast<int>(atomicAdd(counter, 1u));
  __syncthreads();
  const int tile = s_tile;
  const int row = tile / tiles_per_row;
  const int k = tile - row * tiles_per_row;
  const int t0 = k * kTile + tid * kItems;  // the thread's first slot
  const size_t off = static_cast<size_t>(row) * n + t0;

  uint32_t fw[kWords], mw[kWords];
  load_flags(first, off, t0, n, fw);
  if constexpr (Op::kValued) {
    // the tile's values into shared memory, the identity past the row's
    // end; a warp load reads 512 contiguous bytes
    const int* src = values + (off - tid * kItems);
    if (k * kTile + kTile <= n &&
        (reinterpret_cast<uintptr_t>(src) & 15u) == 0u) {
#pragma unroll
      for (int q = 0; q < kItems / 4; ++q) {
        const int s = 4 * (q * kThreads + tid);
        *reinterpret_cast<int4*>(staged + padded(s)) =
            __ldcs(reinterpret_cast<const int4*>(src + s));
      }
    } else {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int s = i * kThreads + tid;
        staged[padded(s)] = k * kTile + s < n ? src[s] : Op::kIdentity;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kWords; ++j) mw[j] = 0u;  // unread
  } else {
    load_flags(marked, off, t0, n, mw);
  }

  // the thread's run, from its own start; its outputs are computed again
  // once the carry is known, so that only the flags stay in registers
  State mine = {Op::kIdentity, false};
#pragma unroll
  for (int q = 0; q < kItems / 4; ++q) {
    const int4 x4 = values_at<Op>(staged, tid * kItems + 4 * q);
    const int x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 4 * q + j;
      if (byte_at(fw, i)) mine = {Op::kIdentity, true};
      step_at<Op>(mine.v, mw, i, t0, x[j]);
    }
  }

  // the warp: inclusive, then the state before each lane
  State inc = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const State o = shfl_up(inc, d);
    if (lane >= d) inc = cat<Op>(o, inc);
  }
  State before = shfl_up(inc, 1);
  if (lane == 0) before = {Op::kIdentity, false};
  if (lane == 31) {
    warp_v[warp] = inc.v;
    warp_r[warp] = inc.r;
  }
  if (tid == 0) s_head_first = byte_at(fw, 0);
  __syncthreads();

  // the CTA: the state before this warp, and the tile's aggregate
  State agg = {Op::kIdentity, false}, before_warp = agg;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) before_warp = agg;
    agg = cat<Op>(agg, State{warp_v[w], warp_r[w]});
  }
  before = cat<Op>(before_warp, before);

  if (warp == 0) {
    uint64_t* mine_desc = desc + tile;
    if (lane == 0)
      store_relaxed(mine_desc, pack(k == 0 || agg.r ? kPrefix : kAggregate,
                                    agg));
    int prefix = Op::kIdentity;
    if (k > 0 && !s_head_first) {  // the tile's head continues a group
      const uint64_t* row_desc = desc + (tile - k);
      const uint64_t none = pack(kPrefix, State{Op::kIdentity, false});
      for (int j = k - 1;; j -= 32) {
        const int t = j - lane;
        uint64_t d = t >= 0 ? load_relaxed(row_desc + t) : none;
        while (__any_sync(kFull, (d & kStatus) == 0u))
          if ((d & kStatus) == 0u) d = load_relaxed(row_desc + t);
        const unsigned stop =
            __ballot_sync(kFull, (d & kStatus) == kPrefix || (d & kReset));
        int v = static_cast<int>(static_cast<uint32_t>(d));
        // lanes past the nearest stop lie before its state: not counted
        if (stop != 0u && lane > __ffs(stop) - 1) v = Op::kIdentity;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          v = Op::op(v, __shfl_xor_sync(kFull, v, o));
        prefix = Op::op(prefix, v);
        if (stop != 0u) break;
      }
      if (lane == 0 && !agg.r)
        store_relaxed(mine_desc,
                      pack(kPrefix, State{Op::op(prefix, agg.v), false}));
    }
    if (lane == 0) s_prefix = prefix;
  }
  __syncthreads();

  // the thread's slots again, from the carry into its first slot; a whole
  // tile goes out through shared memory, so that each warp writes 512
  // contiguous bytes a store (ops 2 and 3 overwrite their own values)
  int v = cat<Op>(State{s_prefix, false}, before).v;
  int* tile_out = out + (off - tid * kItems);
  if (k * kTile + kTile <= n &&
      (reinterpret_cast<uintptr_t>(tile_out) & 15u) == 0u) {
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      const int s = tid * kItems + 4 * q;
      const int4 x4 = values_at<Op>(staged, s);
      const int x[4] = {x4.x, x4.y, x4.z, x4.w};
      int o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 4 * q + j;
        if (byte_at(fw, i)) v = Op::kIdentity;
        o[j] = step_at<Op>(v, mw, i, t0, x[j]);
      }
      *reinterpret_cast<int4*>(staged + padded(s)) =
          make_int4(o[0], o[1], o[2], o[3]);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      const int s = 4 * (q * kThreads + tid);
      __stcs(reinterpret_cast<int4*>(tile_out + s),
             *reinterpret_cast<const int4*>(staged + padded(s)));
    }
  } else {
    int* dst = out + off;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (byte_at(fw, i)) v = Op::kIdentity;
      const int x = Op::kValued ? staged[padded(tid * kItems + i)] : 0;
      const int o = step_at<Op>(v, mw, i, t0, x);
      if (t0 + i < n) dst[i] = o;
    }
  }
}

template <class Op>
int launch(const unsigned char* first, const unsigned char* marked,
           const int* values, int* out, void* scratch, int B, int n,
           void* stream) {
  if (B < 1 || n < 1 || n > INT_MAX - kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_per_row = (n + kTile - 1) / kTile;
  const long long tiles = static_cast<long long>(B) * tiles_per_row;
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(
      scratch, 0, static_cast<size_t>(tiles + 1) * sizeof(uint64_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  seg_scan_kernel<Op><<<static_cast<int>(tiles), kThreads, 0, s>>>(
      first, marked, values, out, static_cast<unsigned*>(scratch),
      static_cast<uint64_t*>(scratch) + 1, n, tiles_per_row);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scratch, for both entry points: 1 + B * ceil(n / 4096) 64-bit words of
// the caller's (the tile counter, then one descriptor a tile), cleared
// here on the stream.  first may be null (each row one group).

// op 0: last-marked, op 1: exclusive count, over bool `marked`.
extern "C" int otz_seg_scan(const unsigned char* first,
                            const unsigned char* marked, int* out,
                            void* scratch, int B, int n, int op,
                            void* stream) {
  if (op == 0)
    return launch<LastMarked>(first, marked, nullptr, out, scratch, B, n,
                              stream);
  if (op == 1)
    return launch<ExclCount>(first, marked, nullptr, out, scratch, B, n,
                             stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// op 2: running max, op 3: exclusive sum, over int32 `values`.
extern "C" int otz_seg_scan_values(const unsigned char* first,
                                   const int* values, int* out,
                                   void* scratch, int B, int n, int op,
                                   void* stream) {
  if (op == 2)
    return launch<RunningMax>(first, nullptr, values, out, scratch, B, n,
                              stream);
  if (op == 3)
    return launch<ExclSum>(first, nullptr, values, out, scratch, B, n,
                           stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
