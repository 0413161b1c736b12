// The lane solve of kernels B1-B4 for Hopper (sm_90a), shared by
// ffd.cu (B1, B2, B3) and stream_bf.cu (B4).
//
// Every candidate lane is an independent fork of the spot pool: its K
// pod slots are placed in order, each on the first fitting spot
// (first-fit) or on the fitting spot of least primary-resource slack,
// ties to the lowest index (best-fit); a lane is feasible when every
// valid slot placed. The design (see ffd.cu for what bounds it):
//
// 1. Spot statics staged once per block and shared by its L lanes, as
//    structure-of-arrays planes in shared memory: free f32 [R][S],
//    room = ok ? max_pods - count : 0 (i32 [S]; exact for
//    `ok && count < max_pods`, since a commit only ever raises count),
//    taints [W][S] and aff [A][S]. Lane t of a warp reads spot 32w+t, so
//    a window of 32 spots is one conflict-free read per plane. Where the
//    statics do not fit beside the lanes' state, the same code reads them
//    from device memory (L2) instead.
// 2. Each lane holds only what it changed: an overlay of up to K
//    touched-spot entries (the entry of slot k is created by slot k) and
//    a touched bitmap of ceil(S/32) words. What an entry holds is the
//    overlay policy's: B1-B3 (AbsOverlay) hold the spot's absolute free,
//    room and aff, B4 (DeltaOverlay) the narrow deltas of its carry
//    layout, widened against the statics at each test.
// 3. The lane's slot rows (req, tol, aff, valid) are staged with the
//    statics: nothing in the slot loop reads device memory; the only
//    store is `chosen` of a placed slot. Where R, W, A = 4, 1, 2 an
//    instance with those counts fixed at compile time holds the slot's
//    words in registers and unrolls every predicate loop.
// 4. First-fit: one warp per lane, a __ballot_sync per window of 32
//    spots, stopping at the first window with a fit. Best-fit: P warps
//    per lane; warp j scans windows j, j+P, ... and keeps its
//    lexicographic (slack, index) minimum, two __reduce_min_sync elect
//    the warp's, and the P partials meet in shared memory behind ONE
//    named barrier a slot (bar.sync 1+lane, 32*P), double buffered.
//    Window w's touched bits and entries are written only by warp w % P
//    (the owner commits), so no other barrier is needed.
// 5. Spot chunks (B3): the spot axis is walked in ordered chunks of Sc
//    spots, the outer loop of the block. Each chunk's statics are staged
//    once, every lane with pods left runs them against the chunk with a
//    fresh overlay (chunks share no spot), and `chosen` carries the
//    placements across chunks with the chunk's offset added. One chunk
//    is B1.
// 6. A persistent grid: as many blocks G as CUDA's occupancy keeps
//    resident at once, lane slot j of block b solving lanes
//    b + G*(j + L*i). A block whose lanes are all invalid writes its
//    outputs and returns before staging.
// 8. A tenant axis (B1t/B2t, the planner service's batch): T problems
//    of one shape stacked along a leading axis launch as one grid of
//    G x T blocks, gridDim.y = T. Block (b, t) offsets every input and
//    output by tenant t's stride and solves tenant t's lanes alone, so
//    it stages tenant t's statics once, as a launch of one problem
//    does; the persistent grid G is the occupancy split over the T
//    tenants, and past shared memory the workspace holds G*T*L lanes,
//    block (b, t) carving slots [(t*G + b)*L, (t*G + b + 1)*L). Only
//    the TENANTS instances read blockIdx.y and move their pointers: a
//    launch of one problem (B1-B4, the controller's path) runs an
//    instance without the offsets, which cost the solo launches 2-5% of
//    device time when every instance computed them.
// 7. A lane's state (slot rows, overlay, touched bitmap, partials) sits
//    in shared memory after the staged statics. Where one lane alone
//    passes a block's shared memory (K in the thousands), the wrapper
//    passes a device-memory workspace of G*L lanes instead and block b
//    carves its L lanes from slots [b*L, (b+1)*L) of it: the same code
//    on generic pointers, read through L1/L2 like the statics past
//    shared memory. The lane's barriers (__syncwarp, bar.sync) order
//    its global accesses as they order shared ones.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <mutex>
#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;
constexpr int kMaxNamedLanes = 15;  // bar.sync ids 1..15, one per lane
// R, W and A of the fixed instance: four resources, one taint word and
// two affinity words, the planner's pack of configs 3 and 4
constexpr int kFixedR = 4;
constexpr int kFixedW = 1;
constexpr int kFixedA = 2;

// An unsigned key of a slack that orders as the floats do (-0 as +0),
// for the warp's integer min-reductions.
__device__ __forceinline__ unsigned slack_key(float slack) {
  const unsigned u = __float_as_uint(slack + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The warp's lexicographic minimum of (key, idx): two reductions.
__device__ __forceinline__ void warp_min(unsigned& key, unsigned& idx) {
  const unsigned kmin = __reduce_min_sync(kFull, key);
  idx = __reduce_min_sync(kFull, key == kmin ? idx : 0xffffffffu);
  key = kmin;
}

// f(i) for i in [0, n): unrolled when n is the compile-time count M, a
// plain loop when M is 0.
template <int M, class F>
__device__ __forceinline__ void each(int n, F&& f) {
  if constexpr (M > 0) {
#pragma unroll
    for (int i = 0; i < M; ++i) f(i);
  } else {
    for (int i = 0; i < n; ++i) f(i);
  }
}

// Pods a spot still takes, 0 when it takes none: the fit test is
// room > 0 and a commit subtracts one.
__host__ __device__ __forceinline__ int room_of(uint8_t ok, int count,
                                                int max_pods) {
  if (!ok || count >= max_pods) return 0;
  const long long gap = (long long)max_pods - count;
  return gap > INT_MAX ? INT_MAX : (int)gap;
}

__host__ __device__ __forceinline__ long long statics_words(int S, int R,
                                                            int W, int A) {
  return (long long)S * (R + 1 + W + A);
}

// 32-bit words of one lane's state (see Lane) over S spots, with an
// overlay payload of `overlay_words` words.
__host__ __device__ __forceinline__ long long lane_words(
    int K, int R, int W, int A, int S, int P, long long overlay_words) {
  return (long long)K * (R + W + A + 2) + overlay_words + (S + 31) / 32 +
         4LL * P;
}

// The statics staged in shared memory, structure of arrays.
struct SmemStatics {
  const float* free;      // [R][S]
  const int32_t* room;    // [S]
  const int32_t* taints;  // [W][S]
  const int32_t* aff;     // [A][S]
  int S;
  __device__ __forceinline__ float free_at(int r, int s) const {
    return free[r * S + s];
  }
  __device__ __forceinline__ int room_at(int s) const { return room[s]; }
  __device__ __forceinline__ int32_t taint_at(int w, int s) const {
    return taints[w * S + s];
  }
  __device__ __forceinline__ int32_t aff_at(int a, int s) const {
    return aff[a * S + s];
  }
};

// The statics read in place from device memory, for a pool too large to
// stage beside the lanes; the pointers start at the chunk's first spot.
struct GlobalStatics {
  const float* free;        // [S, R]
  const int32_t* count;     // [S]
  const int32_t* max_pods;  // [S]
  const uint8_t* ok;        // [S]
  const int32_t* taints;    // [S, W]
  const int32_t* aff;       // [S, A]
  int R, W, A;
  __device__ __forceinline__ float free_at(int r, int s) const {
    return __ldg(free + (size_t)s * R + r);
  }
  __device__ __forceinline__ int room_at(int s) const {
    return room_of(__ldg(ok + s), __ldg(count + s), __ldg(max_pods + s));
  }
  __device__ __forceinline__ int32_t taint_at(int w, int s) const {
    return __ldg(taints + (size_t)s * W + w);
  }
  __device__ __forceinline__ int32_t aff_at(int a, int s) const {
    return __ldg(aff + (size_t)s * A + a);
  }
};

// The spot arrays of a launch, as the kernels take them.
struct Spots {
  const float* free;        // [S, R]
  const int32_t* count;     // [S]
  const int32_t* max_pods;  // [S]
  const int32_t* taints;    // [S, W]
  const uint8_t* ok;        // [S]
  const int32_t* aff;       // [S, A]
};

// Block-wide: the statics of spots [off, off + n), staged at `sh` (to be
// followed by a __syncthreads) or read in place.
__device__ __forceinline__ SmemStatics stage_statics(int32_t* sh,
                                                     const Spots& sp, int off,
                                                     int n, int R, int W,
                                                     int A) {
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  float* free_sh = reinterpret_cast<float*>(sh);
  int32_t* room_sh = sh + R * n;
  int32_t* taint_sh = room_sh + n;
  int32_t* aff_sh = taint_sh + W * n;
  const float* free = sp.free + (size_t)off * R;
  const int32_t* taints = sp.taints + (size_t)off * W;
  const int32_t* aff = sp.aff + (size_t)off * A;
#pragma unroll 4
  for (int i = tid; i < n * R; i += T) free_sh[(i % R) * n + i / R] = free[i];
#pragma unroll 4
  for (int s = tid; s < n; s += T)
    room_sh[s] = room_of(sp.ok[off + s], sp.count[off + s],
                         sp.max_pods[off + s]);
#pragma unroll 4
  for (int i = tid; i < n * W; i += T) taint_sh[(i % W) * n + i / W] = taints[i];
#pragma unroll 4
  for (int i = tid; i < n * A; i += T) aff_sh[(i % A) * n + i / A] = aff[i];
  return SmemStatics{free_sh, room_sh, taint_sh, aff_sh, n};
}

__device__ __forceinline__ GlobalStatics global_statics(const Spots& sp,
                                                        int off, int R, int W,
                                                        int A) {
  return GlobalStatics{sp.free + (size_t)off * R, sp.count + off,
                       sp.max_pods + off, sp.ok + off,
                       sp.taints + (size_t)off * W, sp.aff + (size_t)off * A,
                       R, W, A};
}

// One slot's words: in registers in the fixed instance, else read from
// the staged rows.
template <bool FIXED>
struct Slot {
  static constexpr int MR = FIXED ? kFixedR : 0;
  static constexpr int MW = FIXED ? kFixedW : 0;
  static constexpr int MA = FIXED ? kFixedA : 0;
  float req_r[FIXED ? kFixedR : 1];
  int32_t tol_r[FIXED ? kFixedW : 1];
  int32_t aff_r[FIXED ? kFixedA : 1];
  const float* req_p;
  const int32_t* tol_p;
  const int32_t* aff_p;

  __device__ __forceinline__ Slot(const float* req, const int32_t* tol,
                                  const int32_t* aff)
      : req_p(req), tol_p(tol), aff_p(aff) {
    if constexpr (FIXED) {
#pragma unroll
      for (int i = 0; i < kFixedR; ++i) req_r[i] = req_p[i];
#pragma unroll
      for (int i = 0; i < kFixedW; ++i) tol_r[i] = tol_p[i];
#pragma unroll
      for (int i = 0; i < kFixedA; ++i) aff_r[i] = aff_p[i];
    }
  }
  __device__ __forceinline__ float req(int i) const {
    if constexpr (FIXED) return req_r[i];
    else return req_p[i];
  }
  __device__ __forceinline__ int32_t tol(int i) const {
    if constexpr (FIXED) return tol_r[i];
    else return tol_p[i];
  }
  __device__ __forceinline__ int32_t aff(int i) const {
    if constexpr (FIXED) return aff_r[i];
    else return aff_p[i];
  }
};

// B1-B3's overlay: an entry holds the touched spot's absolute values,
// copied from the statics by the first commit, then updated in place in
// the old fork's order (f32 subtractions, so integral slacks stay exact).
// Words: room [K], free [R][K], aff [A][K].
struct AbsOverlay {
  int32_t* room;
  float* free;
  int32_t* aff;

  __host__ __device__ static long long words(int K, int R, int A, int) {
    return (long long)K * (R + 1 + A);
  }
  __device__ static AbsOverlay carve(int32_t* p, int K, int R, int A, int) {
    AbsOverlay ov;
    ov.room = p;
    ov.free = reinterpret_cast<float*>(p + K);
    ov.aff = p + K * (R + 1);
    return ov;
  }
  // Whether spot s (entry e, or -1) takes the slot; f0 its free[0].
  template <bool FIXED, class Statics>
  __device__ __forceinline__ bool fits(const Statics& st, int s, int e,
                                       const Slot<FIXED>& sl, int K, int R,
                                       int A, float& f0) const {
    using Sl = Slot<FIXED>;
    bool fit;
    if (e >= 0) {
      f0 = free[e];
      fit = room[e] > 0;
      each<Sl::MR>(R, [&](int r) { fit &= free[r * K + e] >= sl.req(r); });
      each<Sl::MA>(A, [&](int a) { fit &= (aff[a * K + e] & sl.aff(a)) == 0; });
    } else {
      f0 = st.free_at(0, s);
      fit = st.room_at(s) > 0;
      each<Sl::MR>(R, [&](int r) { fit &= st.free_at(r, s) >= sl.req(r); });
      each<Sl::MA>(A, [&](int a) { fit &= (st.aff_at(a, s) & sl.aff(a)) == 0; });
    }
    return fit;
  }
  // Field x of the commit of a pod (req, saff) on spot s into entry e:
  // free[x] for x < R, the room for x == R, aff[x-R-1] past it.
  template <class Statics>
  __device__ __forceinline__ void commit(const Statics& st, int x, int s,
                                         int e, bool fresh, const float* req,
                                         const int32_t* saff, int K,
                                         int R) const {
    if (x < R) {
      float f = fresh ? st.free_at(x, s) : free[x * K + e];
      f -= req[x];
      free[x * K + e] = f;
    } else if (x == R) {
      room[e] = (fresh ? st.room_at(s) : room[e]) - 1;
    } else {
      const int a = x - R - 1;
      aff[a * K + e] = (fresh ? st.aff_at(a, s) : aff[a * K + e]) | saff[a];
    }
  }
};

// Element sizes of B4's dtype codes (ops/ffd_kernels.py): used
// int16/uint16/f32, count int8/int16/int32, aff uint8/uint16/uint32.
__host__ __device__ __forceinline__ int used_size(int code) {
  return code == 2 ? 4 : 2;
}
__host__ __device__ __forceinline__ int code_size(int code) {
  return 1 << code;
}
// The three codes of a launch, packed as used | count << 8 | aff << 16.
__host__ __device__ __forceinline__ int code_of(int codes, int plane) {
  return (codes >> (8 * plane)) & 0xff;
}
__host__ __device__ __forceinline__ long long words_of(long long bytes) {
  return (bytes + 3) / 4;
}

// B4's overlay: an entry holds the narrow DELTA carry of its spot in the
// layout's own dtypes, as the TPU kernel holds it: capacity consumed
// `used` [R][K], placements added `dcount` [K], placed pods' affinity
// bits `daff` [A][K], each plane padded to a word. A test widens them
// against the statics (free = free0 - used, room - dcount, aff | daff);
// a commit adds or ORs and narrows on store, exact within the layout's
// guard. The dtypes are codes read at run time: block-uniform branches.
struct DeltaOverlay {
  unsigned char* used;
  unsigned char* dcount;
  unsigned char* daff;
  int ucode, ncode, acode;

  __host__ __device__ static long long words(int K, int R, int A,
                                             int codes) {
    return words_of((long long)R * K * used_size(code_of(codes, 0))) +
           words_of((long long)K * code_size(code_of(codes, 1))) +
           words_of((long long)A * K * code_size(code_of(codes, 2)));
  }
  __device__ static DeltaOverlay carve(int32_t* p, int K, int R, int A,
                                       int codes) {
    DeltaOverlay ov;
    ov.ucode = code_of(codes, 0);
    ov.ncode = code_of(codes, 1);
    ov.acode = code_of(codes, 2);
    ov.used = reinterpret_cast<unsigned char*>(p);
    p += words_of((long long)R * K * used_size(ov.ucode));
    ov.dcount = reinterpret_cast<unsigned char*>(p);
    p += words_of((long long)K * code_size(ov.ncode));
    ov.daff = reinterpret_cast<unsigned char*>(p);
    return ov;
  }
  __device__ __forceinline__ float used_at(int i) const {
    if (ucode == 0) return (float)reinterpret_cast<const int16_t*>(used)[i];
    if (ucode == 1) return (float)reinterpret_cast<const uint16_t*>(used)[i];
    return reinterpret_cast<const float*>(used)[i];
  }
  __device__ __forceinline__ int dcount_at(int e) const {
    if (ncode == 0) return reinterpret_cast<const int8_t*>(dcount)[e];
    if (ncode == 1) return reinterpret_cast<const int16_t*>(dcount)[e];
    return reinterpret_cast<const int32_t*>(dcount)[e];
  }
  __device__ __forceinline__ int32_t daff_at(int i) const {
    if (acode == 0) return (int32_t)reinterpret_cast<const uint8_t*>(daff)[i];
    if (acode == 1) return (int32_t)reinterpret_cast<const uint16_t*>(daff)[i];
    return reinterpret_cast<const int32_t*>(daff)[i];
  }
  template <bool FIXED, class Statics>
  __device__ __forceinline__ bool fits(const Statics& st, int s, int e,
                                       const Slot<FIXED>& sl, int K, int R,
                                       int A, float& f0) const {
    using Sl = Slot<FIXED>;
    bool fit;
    if (e >= 0) {  // widen on read
      f0 = st.free_at(0, s) - used_at(e);
      fit = st.room_at(s) - dcount_at(e) > 0;
      each<Sl::MR>(R, [&](int r) {
        fit &= st.free_at(r, s) - used_at(r * K + e) >= sl.req(r);
      });
      each<Sl::MA>(A, [&](int a) {
        fit &= ((st.aff_at(a, s) | daff_at(a * K + e)) & sl.aff(a)) == 0;
      });
    } else {  // a zero delta: the statics as they are
      f0 = st.free_at(0, s);
      fit = st.room_at(s) > 0;
      each<Sl::MR>(R, [&](int r) { fit &= st.free_at(r, s) >= sl.req(r); });
      each<Sl::MA>(A, [&](int a) { fit &= (st.aff_at(a, s) & sl.aff(a)) == 0; });
    }
    return fit;
  }
  // Field x of the commit, as AbsOverlay's; a fresh entry starts at a
  // zero delta. used += (UsedT)req, dcount += 1, daff |= (AffT)saff.
  template <class Statics>
  __device__ __forceinline__ void commit(const Statics&, int x, int, int e,
                                         bool fresh, const float* req,
                                         const int32_t* saff, int K,
                                         int R) const {
    if (x < R) {
      const int i = x * K + e;
      const float q = req[x];
      if (ucode == 0) {
        int16_t* u = reinterpret_cast<int16_t*>(used) + i;
        *u = (int16_t)((fresh ? 0 : *u) + (int16_t)q);
      } else if (ucode == 1) {
        uint16_t* u = reinterpret_cast<uint16_t*>(used) + i;
        *u = (uint16_t)((fresh ? 0u : (unsigned)*u) + (uint16_t)q);
      } else {
        float* u = reinterpret_cast<float*>(used) + i;
        *u = (fresh ? 0.0f : *u) + q;
      }
    } else if (x == R) {
      if (ncode == 0) {
        int8_t* n = reinterpret_cast<int8_t*>(dcount) + e;
        *n = (int8_t)((fresh ? 0 : *n) + 1);
      } else if (ncode == 1) {
        int16_t* n = reinterpret_cast<int16_t*>(dcount) + e;
        *n = (int16_t)((fresh ? 0 : *n) + 1);
      } else {
        int32_t* n = reinterpret_cast<int32_t*>(dcount) + e;
        *n = (fresh ? 0 : *n) + 1;
      }
    } else {
      const int i = (x - R - 1) * K + e;
      const uint32_t bits = (uint32_t)saff[x - R - 1];  // int32 bits
      if (acode == 0) {
        uint8_t* d = reinterpret_cast<uint8_t*>(daff) + i;
        *d = (uint8_t)((fresh ? 0u : (uint32_t)*d) | (uint8_t)bits);
      } else if (acode == 1) {
        uint16_t* d = reinterpret_cast<uint16_t*>(daff) + i;
        *d = (uint16_t)((fresh ? 0u : (uint32_t)*d) | (uint16_t)bits);
      } else {
        uint32_t* d = reinterpret_cast<uint32_t*>(daff) + i;
        *d = (fresh ? 0u : *d) | bits;
      }
    }
  }
};

// One lane's state in shared memory (or in the device-memory workspace),
// lane_words() words in this order.
template <class Overlay>
struct Lane {
  float* req;                 // [K][R] slot requests
  int32_t* tol;               // [K][W] slot tolerations
  int32_t* saff;              // [K][A] slot affinity bits
  int32_t* valid;             // [K] slots still to place
  volatile int32_t* ent_idx;  // [K] spot of the entry slot k created, or -1
  Overlay ov;                 // the entries' values
  uint32_t* touched;          // [ceil(S/32)] bit per spot with an entry
  uint32_t* red_key;          // [2][P] best-fit's partials, double buffered
  uint32_t* red_idx;          // [2][P]
};

template <class Overlay>
__device__ __forceinline__ Lane<Overlay> carve(int32_t* p, int K, int R,
                                               int W, int A, int S, int P,
                                               int codes) {
  Lane<Overlay> ls;
  ls.req = reinterpret_cast<float*>(p);
  p += K * R;
  ls.tol = p;
  p += K * W;
  ls.saff = p;
  p += K * A;
  ls.valid = p;
  p += K;
  ls.ent_idx = p;
  p += K;
  ls.ov = Overlay::carve(p, K, R, A, codes);
  p += Overlay::words(K, R, A, codes);
  ls.touched = reinterpret_cast<uint32_t*>(p);
  p += (S + 31) / 32;
  ls.red_key = reinterpret_cast<uint32_t*>(p);
  p += 2 * P;
  ls.red_idx = reinterpret_cast<uint32_t*>(p);
  return ls;
}

// Warp-wide: the entry of this lane's spot in window w (whose touched
// word is `word`, nonzero), or -1. Window w's entries are written only by
// the warp that owns it, which is this one; another warp's concurrent
// entry is -1 or a spot outside w, so it never matches.
template <class Overlay>
__device__ __forceinline__ int lookup_window(const Lane<Overlay>& ls, int w,
                                             unsigned word, int K) {
  const int lane = threadIdx.x & 31;
  int e = -1;
  int left = __popc(word);
  for (int base = 0; base < K && left > 0; base += 32) {
    const int u = base + lane;
    const int idx = u < K ? ls.ent_idx[u] : -1;
    unsigned m = __ballot_sync(kFull, idx >= 0 && (idx >> 5) == w);
    left -= __popc(m);
    while (m != 0u) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      if ((__shfl_sync(kFull, idx, src) & 31) == lane) e = base + src;
    }
  }
  return e;
}

// Warp-wide: the entry of spot s, which has one.
template <class Overlay>
__device__ __forceinline__ int lookup_spot(const Lane<Overlay>& ls, int s,
                                           int K) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < K; base += 32) {
    const int u = base + lane;
    const unsigned m = __ballot_sync(kFull, u < K && ls.ent_idx[u] == s);
    if (m != 0u) return base + __ffs(m) - 1;
  }
  return -1;
}

// Warp-wide: whether this lane's spot of window w takes the slot's pod;
// `slack` is free[0] - req[0] there and `e` the spot's overlay entry or
// -1. Every predicate is evaluated, no short-circuit loads.
template <bool FIXED, class Overlay, class Statics>
__device__ __forceinline__ bool test_window(const Statics& st,
                                            const Lane<Overlay>& ls, int w,
                                            const Slot<FIXED>& sl, int K,
                                            int R, int W, int A, int S,
                                            float& slack, int& e) {
  using Sl = Slot<FIXED>;
  const int lane = threadIdx.x & 31;
  const unsigned word = ls.touched[w];  // one address: a broadcast
  e = word != 0u ? lookup_window(ls, w, word, K) : -1;
  const int s = (w << 5) + lane;
  if (s >= S) return false;
  float f0;
  bool fit = ls.ov.fits(st, s, e, sl, K, R, A, f0);
  each<Sl::MW>(W, [&](int x) { fit &= (st.taint_at(x, s) & ~sl.tol(x)) == 0; });
  slack = f0 - sl.req(0);
  return fit;
}

// Warp-wide, by the warp that owns spot s's window: place slot k's pod
// on s in the overlay, into entry e, or into a new entry k when e < 0.
// Lane x < R updates field x (free or used), lane R the count, lane
// R+1+a aff[a].
template <class Overlay, class Statics>
__device__ __forceinline__ void commit(const Statics& st,
                                       const Lane<Overlay>& ls, int s, int k,
                                       int e, int K, int R, int A) {
  const int lane = threadIdx.x & 31;
  const bool fresh = e < 0;
  if (fresh) e = k;
  for (int x = lane; x < R + 1 + A; x += 32)
    ls.ov.commit(st, x, s, e, fresh, ls.req + k * R, ls.saff + k * A, K, R);
  if (fresh && lane == 0) {
    ls.ent_idx[e] = s;
    ls.touched[s >> 5] |= 1u << (s & 31);
  }
  __syncwarp();
}

// The barrier of one lane's P warps.
__device__ __forceinline__ void lane_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The barrier between a lane's P warps: a named barrier, or the warp's
// own when P = 1.
template <int P>
__device__ __forceinline__ void lane_sync(int j) {
  if constexpr (P > 1) {
    lane_barrier(1 + j, 32 * P);
  } else {
    __syncwarp();
  }
}

// The lane's warps place its valid slots on the S spots of `st` in
// order: first-fit stops at the first window with a fit, best-fit elects
// over every window. Returns whether every valid slot placed; warp 0
// stores `chosen` (offset by `off`) of each placed slot.
template <bool BEST_FIT, int P, bool FIXED, class Overlay, class Statics>
__device__ __forceinline__ bool solve_lane(const Statics& st,
                                           const Lane<Overlay>& ls, int j,
                                           int jw, int32_t* chosen_c, int off,
                                           int K, int R, int W, int A,
                                           int S) {
  const int lane = threadIdx.x & 31;
  const int nwin = (S + 31) / 32;
  bool feas = true;
  int step = 0;  // valid slots so far: the parity of best-fit's partials
  for (int k = 0; k < K; ++k) {
    if (!ls.valid[k]) continue;  // uniform across the lane's warps
    const Slot<FIXED> sl(ls.req + k * R, ls.tol + k * W, ls.saff + k * A);
    int s = -1;
    int e = -1;  // the winner's overlay entry, -1 for none
    if constexpr (!BEST_FIT) {
      for (int w = 0; w < nwin; ++w) {
        float slack;
        int ew;
        const unsigned m = __ballot_sync(
            kFull, test_window(st, ls, w, sl, K, R, W, A, S, slack, ew));
        if (m != 0u) {
          const int src = __ffs(m) - 1;
          s = (w << 5) + src;
          e = __shfl_sync(kFull, ew, src);
          break;
        }
      }
    } else {
      float best = __int_as_float(0x7f800000);  // +inf: none yet
      unsigned idx = 0xffffffffu;
      for (int w = jw; w < nwin; w += P) {
        float slack;
        int ew;
        const bool fit = test_window(st, ls, w, sl, K, R, W, A, S, slack, ew);
        // windows ascend: a strict < keeps each thread's first index
        if (fit && slack < best) {
          best = slack;
          idx = (w << 5) + lane;
        }
      }
      unsigned key = slack_key(best);
      warp_min(key, idx);
      if constexpr (P > 1) {
        uint32_t* rk = ls.red_key + (step & 1) * P;
        uint32_t* ri = ls.red_idx + (step & 1) * P;
        if (lane == 0) {
          rk[jw] = key;
          ri[jw] = idx;
        }
        lane_barrier(1 + j, 32 * P);  // the slot's one barrier
        key = lane < P ? rk[lane] : 0xffffffffu;
        idx = lane < P ? ri[lane] : 0xffffffffu;
        warp_min(key, idx);
      }
      if (idx != 0xffffffffu) s = (int)idx;
    }
    ++step;
    if (s < 0) {
      feas = false;  // a valid pod fits nowhere; later slots still place
      continue;
    }
    if (jw == 0 && lane == 0) chosen_c[k] = off + s;
    if ((s >> 5) % P == jw) {  // the owner of s's window commits
      if constexpr (BEST_FIT) {
        if ((ls.touched[s >> 5] >> (s & 31)) & 1u) e = lookup_spot(ls, s, K);
      }
      commit(st, ls, s, k, e, K, R, A);
    }
  }
  return feas;
}

// The kernel of B1-B4. A persistent grid of G blocks (gridDim.x) for
// each of T stacked problems (gridDim.y, 1 for one problem): block
// (b, t) walks tenant t's spot axis in chunks of Sc spots (one chunk
// unless first-fit is given Sc < S); for each it stages the chunk's
// statics once, then its lane j (warps [j*P, (j+1)*P)) solves tenant
// t's lanes c = b + G*(j + L*i), i = 0, 1, ..., that still have pods
// to place. The pointers are tenant 0's; tenant t's lie C*K*R, C*K,
// C*K*W, C*K*A, C, S*R, S, S, S*W, S, S*A, C and C*K elements on.
// `codes` are the overlay's dtype codes (B4); `lane_ws` is the lanes'
// device-memory workspace, or nullptr to carve them from shared memory
// (always nullptr for the FIXED instances). Only TENANTS instances solve
// tenant blockIdx.y; the others solve tenant 0 with gridDim.y = 1.
template <bool BEST_FIT, int P, bool SMEM_STATICS, bool FIXED, class Overlay,
          bool TENANTS = false>
__global__ void __launch_bounds__(kMaxThreads)
greedy_kernel(const float* __restrict__ slot_req,          // [C, K, R]
              const uint8_t* __restrict__ slot_valid,      // [C, K]
              const int32_t* __restrict__ slot_tol,        // [C, K, W]
              const int32_t* __restrict__ slot_aff,        // [C, K, A]
              const uint8_t* __restrict__ cand_valid,      // [C]
              const float* __restrict__ spot_free,         // [S, R]
              const int32_t* __restrict__ spot_count,      // [S]
              const int32_t* __restrict__ spot_max_pods,   // [S]
              const int32_t* __restrict__ spot_taints,     // [S, W]
              const uint8_t* __restrict__ spot_ok,         // [S]
              const int32_t* __restrict__ spot_aff,        // [S, A]
              uint8_t* __restrict__ feasible,              // [C]
              int32_t* __restrict__ chosen,                // [C, K]
              int32_t* __restrict__ lane_ws,  // [G*L lanes] or nullptr
              int C, int K, int R, int W, int A, int S, int Sc, int L,
              int codes) {
  extern __shared__ __align__(16) int32_t smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int G = gridDim.x;
  const int b = blockIdx.x;
  // tenant t's problem: every pointer moves on by t's stride, without a
  // branch on t > 0, which spilled more of the 64 registers a thread of
  // a 1,024-thread block has (ffd_timing.py)
  const size_t tenant = TENANTS ? blockIdx.y : 0;
  if constexpr (TENANTS) {
    const size_t CK = (size_t)C * K;
    slot_req += tenant * CK * R;
    slot_valid += tenant * CK;
    slot_tol += tenant * CK * W;
    slot_aff += tenant * CK * A;
    cand_valid += tenant * C;
    spot_free += tenant * S * R;
    spot_count += tenant * S;
    spot_max_pods += tenant * S;
    spot_taints += tenant * S * W;
    spot_ok += tenant * S;
    spot_aff += tenant * S * A;
    feasible += tenant * C;
    chosen += tenant * CK;
  }
  const int n_lanes = (C - b + G - 1) / G;  // lanes b, b+G, ... below C

  // a block of invalid lanes only writes its outputs
  int mine = 0;
  for (int i = tid; i < n_lanes; i += T) mine |= cand_valid[b + i * G];
  if (!__syncthreads_or(mine)) {
    for (int i = tid; i < n_lanes * K; i += T)
      chosen[(size_t)(b + (i / K) * G) * K + i % K] = -1;
    for (int i = tid; i < n_lanes; i += T) feasible[b + i * G] = 0;
    return;
  }

  const Spots sp{spot_free, spot_count, spot_max_pods, spot_taints, spot_ok,
                 spot_aff};
  const int Sw = S < Sc ? S : Sc;  // the widest chunk
  const int n_chunks = S > Sc ? (S + Sc - 1) / Sc : 1;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int j = warp / P;   // lane slot of the block
  const int jw = warp % P;  // warp within the lane
  const int gt = jw * 32 + lane;
  const long long ov_words = Overlay::words(K, R, A, codes);
  const long long lw = lane_words(K, R, W, A, Sw, P, ov_words);

  // The chunk loop over one lane slot carved from `lanes`. Called with
  // shared memory or with the device-memory workspace: each call is
  // inlined on its own, so the shared-memory call keeps its
  // shared-memory loads and stores, which a pointer that could be
  // either would turn into generic ones. Only the generic (!FIXED)
  // instances compile the workspace call: the launches pick them
  // whenever `lane_ws` is passed, which only K in the thousands needs.
  auto run = [&](int32_t* lanes) {
    const Lane<Overlay> ls =
        carve<Overlay>(lanes + (size_t)j * lw, K, R, W, A, Sw, P, codes);

    for (int q = 0; q < n_chunks; ++q) {
      const int off = q * Sc;
      const int n = S - off < Sc ? S - off : Sc;  // spots of this chunk
      if (q > 0) {
        // `feasible` marks a lane done; the block stops once all are
        int left = 0;
        for (int i = tid; i < n_lanes; i += T) {
          const int c = b + i * G;
          left |= cand_valid[c] && !feasible[c];
        }
        if (!__syncthreads_or(left)) break;
      }
      // the chunk's statics, staged once for the block's lanes
      using Statics = typename std::conditional<SMEM_STATICS, SmemStatics,
                                                GlobalStatics>::type;
      Statics st;
      if constexpr (SMEM_STATICS) {
        st = stage_statics(smem, sp, off, n, R, W, A);
      } else {
        st = global_statics(sp, off, R, W, A);
      }
      __syncthreads();

      // uniform across the lane's warps
      for (int i = j; i < n_lanes; i += L) {
        const int c = b + i * G;
        int32_t* chosen_c = chosen + (size_t)c * K;
        if (q == 0) {
          if (jw == 0)
            for (int k = lane; k < K; k += 32) chosen_c[k] = -1;
          if (!cand_valid[c]) {
            if (jw == 0 && lane == 0) feasible[c] = 0;
            continue;
          }
        } else if (!cand_valid[c] || feasible[c]) {
          continue;  // nothing left to place
        }
        // stage the lane's slot rows (the pods still unplaced) and clear
        // its overlay
        const size_t ck = (size_t)c * K;
        for (int x = gt; x < K * R; x += 32 * P)
          ls.req[x] = slot_req[ck * R + x];
        for (int x = gt; x < K * W; x += 32 * P)
          ls.tol[x] = slot_tol[ck * W + x];
        for (int x = gt; x < K * A; x += 32 * P)
          ls.saff[x] = slot_aff[ck * A + x];
        for (int x = gt; x < K; x += 32 * P) {
          ls.valid[x] = slot_valid[ck + x] && (q == 0 || chosen_c[x] < 0);
          ls.ent_idx[x] = -1;
        }
        for (int x = gt; x < (n + 31) / 32; x += 32 * P) ls.touched[x] = 0u;
        lane_sync<P>(j);  // rows staged, chosen cleared
        const bool feas = solve_lane<BEST_FIT, P, FIXED>(
            st, ls, j, jw, chosen_c, off, K, R, W, A, n);
        if (jw == 0 && lane == 0 && (q == 0 || feas))
          feasible[c] = feas ? 1 : 0;
        lane_sync<P>(j);  // done with the rows before the next lane's
      }
      // done with the chunk's statics
      if (q + 1 < n_chunks) __syncthreads();
    }
  };
  if constexpr (!FIXED) {
    if (lane_ws != nullptr) {
      run(lane_ws + (tenant * G + b) * L * lw);
      return;
    }
  }
  run(smem + (SMEM_STATICS ? statics_words(Sw, R, W, A) : 0));
}

// Per instance and device: the dynamic shared memory allowed so far
// (cudaFuncSetAttribute runs only when a launch needs more), and the
// occupancy last computed, with the block shape it was computed for.
constexpr int kMaxDevices = 64;
struct InstanceState {
  int smem_allowed = 0;
  int threads = 0, smem = -1, per_sm = 0, sms = 0;
};

// Blocks resident at once for kernel `fn` and a block shape on the
// current device: raises the instance's shared-memory allowance, then
// reads CUDA's occupancy (registers, threads, shared memory) times the
// SMs, cached per shape in states[device] under `mu`. 0 with `err` set
// on failure.
inline int resident_blocks(const void* fn, InstanceState* states,
                           std::mutex& mu, int threads, int smem,
                           cudaError_t* err) {
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  std::lock_guard<std::mutex> lock(mu);
  InstanceState scratch;
  InstanceState& is = dev < kMaxDevices ? states[dev] : scratch;
  if (smem > is.smem_allowed) {
    *err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem);
    if (*err != cudaSuccess) return 0;
    is.smem_allowed = smem;
  }
  if (is.threads != threads || is.smem != smem) {
    int sms = 0, per_sm = 0;
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (*err == cudaSuccess)
      *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                           (size_t)smem);
    if (*err != cudaSuccess) return 0;
    if (per_sm < 1) {
      *err = cudaErrorInvalidConfiguration;
      return 0;
    }
    is.threads = threads;
    is.smem = smem;
    is.per_sm = per_sm;
    is.sms = sms;
  }
  return is.sms * is.per_sm;
}

// Largest dynamic shared memory a block of every kernel in `fns` may use
// on `device`, or -1 on error.
inline int max_dynamic_smem(int device, const void* const* fns, int n) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  int static_bytes = 0;
  for (int i = 0; i < n; ++i) {
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, fns[i]) != cudaSuccess) return -1;
    if ((int)attr.sharedSizeBytes > static_bytes)
      static_bytes = (int)attr.sharedSizeBytes;
  }
  return optin - static_bytes;
}

// Blocks of the persistent grid for C lanes, L a block: as many as are
// resident at once, at most one per L lanes.
inline int grid_of(int C, int L, int resident) {
  const int per_lanes = (int)(((long long)C + L - 1) / L);
  return per_lanes < resident ? per_lanes : resident;
}

}  // namespace
