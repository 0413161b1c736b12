// Kernels B1 (first-fit) and B2 (best-fit): the batched greedy drain
// solve for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel k8s_spot_rescheduler_tpu/ops/pallas_ffd.py
// `_kernel` (best_fit=False / True), entered there through
// `plan_ffd_pallas` and `_invoke_kernel`. Semantics are those of
// solver/ffd.plan_ffd: every candidate lane is an independent fork of
// the spot pool; its K pod slots are placed in order, each on the first
// fitting spot (B1) or on the fitting spot of least primary-resource
// slack, ties to the lowest index (B2); a lane is feasible when every
// valid slot placed. The raw outputs keep the placements of a lane after
// one of its slots failed (B3's chunk loop reads them); lanes with
// cand_valid=0 write feasible=0 and chosen=-1.
//
// What bounds it. Not device memory (the inputs are a few MB) and not
// arithmetic: each lane is a serial chain of K slots, and each slot is a
// search over the spot axis, so the time is the latency of that chain and
// the instructions each test costs. Measured at config 3 on one H100
// (PERF.md): B1 stays latency-bound, a slot being about one window whose
// chain of shared-memory reads, ballot and commit takes ~0.8 us; B2 is
// bound by instruction issue and shared-memory loads, since every slot
// tests all S spots (nine shared loads a window). The design cuts both:
//
// 1. Spot statics staged once per block and shared by its L lanes, as
//    structure-of-arrays planes in shared memory: free f32 [R][S],
//    room = ok ? max_pods - count : 0 (i32 [S]; exact for
//    `ok && count < max_pods`, since a commit only ever raises count),
//    taints [W][S] and aff [A][S]. Lane t of a warp reads spot 32w+t, so
//    a window of 32 spots is one conflict-free read per plane. Where the
//    statics do not fit beside the lanes' state, the same code reads them
//    from device memory (L2) instead; there is no workspace.
// 2. Each lane holds only what it changed: an overlay of up to K
//    touched-spot entries (spot index, free[R], room, aff[A]; the entry
//    of slot k is created by slot k) and a touched bitmap of ceil(S/32)
//    words. A test reads the statics unless its spot's bit is set; a
//    commit copies the base values into a new entry the first time a spot
//    is touched, then subtracts or ORs in place (the order of f32
//    subtractions is the old fork's, so integral slacks stay exact).
//    That is 4*(K*(R+A+2) + ceil(S/32)) bytes, not 4*S*(R+1+A), so dozens
//    of lanes fit an SM instead of three.
// 3. The lane's slot rows (req, tol, aff, valid) are staged with the
//    statics: nothing in the slot loop reads device memory; the only
//    store is `chosen` of a placed slot. Where R, W, A = 4, 1, 2
//    (configs 3 and 4) an instance with those counts fixed at compile
//    time holds the slot's words in registers and unrolls every
//    predicate loop without guards; other shapes loop to the counts read
//    at run time.
// 4. B1: one warp per lane, a __ballot_sync per window of 32 spots, and
//    the search stops at the first window with a fit. No block barrier
//    in the slot loop: the commit is one lane and a __syncwarp.
//    B2: P warps per lane (template, 1/2/4/8); warp j scans windows
//    j, j+P, ... and keeps its lexicographic (slack, index) minimum, two
//    __reduce_min_sync (an order-preserving key of the slack, then the
//    index among the lanes that hold it) elect the warp's, and the P
//    partials meet in shared memory behind ONE named barrier a slot
//    (bar.sync 1+lane, 32*P), double buffered so the next slot's
//    partials never overwrite unread ones, where two more reductions
//    elect the lane's.
//    Window w's touched bits and entries are written only by warp w % P
//    (the owner commits), so no other barrier is needed.
// 5. The host picks L, P and where the statics live (ops/ffd_kernels.
//    launch_geometry). The grid is persistent: as many blocks G as CUDA's
//    occupancy keeps resident at once (ffd_blocks), each staging the
//    statics once; lane slot j of block b solves lanes b + G*(j + L*i),
//    so a contiguous run of valid lanes spreads over every block. A block
//    whose lanes are all invalid writes its outputs and returns before
//    staging.
//
// Interface: plain C functions, built with nvcc into a shared library
// and called through ctypes (ops/ffd_kernels.py). The launch runs on the
// given stream, allocates nothing and returns the launch's cudaError_t.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <mutex>
#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;
constexpr int kMaxNamedLanes = 15;  // bar.sync ids 1..15, one per lane
constexpr int kVariants = 5;        // B1, then B2 with P = 1, 2, 4, 8
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

// 32-bit words of one lane's state (see LaneState) and of the statics.
__host__ __device__ __forceinline__ long long lane_words(int K, int R, int W,
                                                         int A, int S, int P) {
  return (long long)K * (2 * R + W + 2 * A + 3) + (S + 31) / 32 + 4LL * P;
}

__host__ __device__ __forceinline__ long long statics_words(int S, int R,
                                                            int W, int A) {
  return (long long)S * (R + 1 + W + A);
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
// stage beside the lanes.
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

// One lane's state in shared memory, lane_words() words in this order.
struct LaneState {
  float* req;                  // [K][R] slot requests
  int32_t* tol;                // [K][W] slot tolerations
  int32_t* saff;               // [K][A] slot affinity bits
  int32_t* valid;              // [K]
  volatile int32_t* ent_idx;   // [K] spot of the entry slot k created, or -1
  int32_t* ent_room;           // [K]
  float* ent_free;             // [R][K]
  int32_t* ent_aff;            // [A][K]
  uint32_t* touched;           // [ceil(S/32)] bit per spot with an entry
  uint32_t* red_key;           // [2][P] B2's partials, double buffered
  uint32_t* red_idx;           // [2][P]
};

__device__ __forceinline__ LaneState carve(int32_t* p, int K, int R, int W,
                                           int A, int S, int P) {
  LaneState ls;
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
  ls.ent_room = p;
  p += K;
  ls.ent_free = reinterpret_cast<float*>(p);
  p += R * K;
  ls.ent_aff = p;
  p += A * K;
  ls.touched = reinterpret_cast<uint32_t*>(p);
  p += (S + 31) / 32;
  ls.red_key = reinterpret_cast<uint32_t*>(p);
  p += 2 * P;
  ls.red_idx = reinterpret_cast<uint32_t*>(p);
  return ls;
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

  __device__ __forceinline__ Slot(const LaneState& ls, int k, int R, int W,
                                  int A)
      : req_p(ls.req + k * R), tol_p(ls.tol + k * W), aff_p(ls.saff + k * A) {
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

// Warp-wide: the entry of this lane's spot in window w (whose touched
// word is `word`, nonzero), or -1. Window w's entries are written only by
// the warp that owns it, which is this one; another warp's concurrent
// entry is -1 or a spot outside w, so it never matches.
__device__ __forceinline__ int lookup_window(const LaneState& ls, int w,
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
__device__ __forceinline__ int lookup_spot(const LaneState& ls, int s, int K) {
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
// -1. Every predicate is evaluated, no short-circuit loads; a touched
// spot is read from its entry.
template <bool FIXED, class Statics>
__device__ __forceinline__ bool test_window(const Statics& st,
                                            const LaneState& ls, int w,
                                            const Slot<FIXED>& sl, int K,
                                            int R, int W, int A, int S,
                                            float& slack, int& e) {
  using Sl = Slot<FIXED>;
  const int lane = threadIdx.x & 31;
  const unsigned word = ls.touched[w];  // one address: a broadcast
  e = word != 0u ? lookup_window(ls, w, word, K) : -1;
  const int s = (w << 5) + lane;
  if (s >= S) return false;
  bool fit;
  float f0;
  if (e >= 0) {
    const int ee = e;
    f0 = ls.ent_free[ee];
    fit = ls.ent_room[ee] > 0;
    each<Sl::MR>(R, [&](int r) { fit &= ls.ent_free[r * K + ee] >= sl.req(r); });
    each<Sl::MA>(A, [&](int a) { fit &= (ls.ent_aff[a * K + ee] & sl.aff(a)) == 0; });
  } else {
    f0 = st.free_at(0, s);
    fit = st.room_at(s) > 0;
    each<Sl::MR>(R, [&](int r) { fit &= st.free_at(r, s) >= sl.req(r); });
    each<Sl::MA>(A, [&](int a) { fit &= (st.aff_at(a, s) & sl.aff(a)) == 0; });
  }
  each<Sl::MW>(W, [&](int x) { fit &= (st.taint_at(x, s) & ~sl.tol(x)) == 0; });
  slack = f0 - sl.req(0);
  return fit;
}

// Warp-wide, by the warp that owns spot s's window: place slot k's pod
// on s in the overlay, into entry e, or into a new entry k when e < 0.
// Lane x < R updates free[x], lane R the room, lane R+1+a aff[a].
template <class Statics>
__device__ __forceinline__ void commit(const Statics& st, const LaneState& ls,
                                       int s, int k, int e, int K, int R,
                                       int A) {
  const int lane = threadIdx.x & 31;
  const bool fresh = e < 0;
  if (fresh) e = k;
  for (int x = lane; x < R + 1 + A; x += 32) {
    if (x < R) {
      float f = fresh ? st.free_at(x, s) : ls.ent_free[x * K + e];
      f -= ls.req[k * R + x];
      ls.ent_free[x * K + e] = f;
    } else if (x == R) {
      ls.ent_room[e] = (fresh ? st.room_at(s) : ls.ent_room[e]) - 1;
    } else {
      const int a = x - R - 1;
      ls.ent_aff[a * K + e] =
          (fresh ? st.aff_at(a, s) : ls.ent_aff[a * K + e]) | ls.saff[k * A + a];
    }
  }
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

// The lane's warps place its valid slots in order: B1 stops at the first
// window with a fit, B2 elects over every window. Returns feasibility;
// warp 0 stores `chosen` of each placed slot.
template <bool BEST_FIT, int P, bool FIXED, class Statics>
__device__ __forceinline__ bool solve_lane(const Statics& st,
                                           const LaneState& ls, int j, int jw,
                                           int32_t* chosen_c, int K, int R,
                                           int W, int A, int S) {
  const int lane = threadIdx.x & 31;
  const int nwin = (S + 31) / 32;
  bool feas = true;
  int step = 0;  // valid slots so far: the parity of B2's partials
  for (int k = 0; k < K; ++k) {
    if (!ls.valid[k]) continue;  // uniform across the lane's warps
    const Slot<FIXED> sl(ls, k, R, W, A);
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
    if (jw == 0 && lane == 0) chosen_c[k] = s;
    if ((s >> 5) % P == jw) {  // the owner of s's window commits
      if constexpr (BEST_FIT) {
        if ((ls.touched[s >> 5] >> (s & 31)) & 1u) e = lookup_spot(ls, s, K);
      }
      commit(st, ls, s, k, e, K, R, A);
    }
  }
  return feas;
}

// A persistent grid of G blocks (gridDim.x): block b stages the statics
// once, then its lane j (warps [j*P, (j+1)*P)) solves lanes
// c = b + G*(j + L*i), i = 0, 1, ..., so neighbouring lanes land in
// different blocks.
template <bool BEST_FIT, int P, bool SMEM_STATICS, bool FIXED>
__global__ void __launch_bounds__(kMaxThreads)
ffd_kernel(const float* __restrict__ slot_req,          // [C, K, R]
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
           int C, int K, int R, int W, int A, int S, int L) {
  extern __shared__ __align__(16) int32_t smem[];
  using Statics =
      typename std::conditional<SMEM_STATICS, SmemStatics, GlobalStatics>::type;
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int G = gridDim.x;
  const int b = blockIdx.x;
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

  // the statics, staged once for the block's lanes
  Statics st;
  int32_t* lanes = smem;
  if constexpr (SMEM_STATICS) {
    float* free_sh = reinterpret_cast<float*>(smem);
    int32_t* room_sh = smem + R * S;
    int32_t* taint_sh = room_sh + S;
    int32_t* aff_sh = taint_sh + W * S;
#pragma unroll 4
    for (int i = tid; i < S * R; i += T) free_sh[(i % R) * S + i / R] = spot_free[i];
#pragma unroll 4
    for (int s = tid; s < S; s += T)
      room_sh[s] = room_of(spot_ok[s], spot_count[s], spot_max_pods[s]);
#pragma unroll 4
    for (int i = tid; i < S * W; i += T) taint_sh[(i % W) * S + i / W] = spot_taints[i];
#pragma unroll 4
    for (int i = tid; i < S * A; i += T) aff_sh[(i % A) * S + i / A] = spot_aff[i];
    lanes = aff_sh + A * S;
    st = SmemStatics{free_sh, room_sh, taint_sh, aff_sh, S};
  } else {
    st = GlobalStatics{spot_free, spot_count, spot_max_pods, spot_ok,
                       spot_taints, spot_aff, R, W, A};
  }
  __syncthreads();  // the block's last barrier

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int j = warp / P;   // lane slot of the block
  const int jw = warp % P;  // warp within the lane
  const int gt = jw * 32 + lane;
  const LaneState ls =
      carve(lanes + (size_t)j * lane_words(K, R, W, A, S, P), K, R, W, A, S, P);
  for (int i = j; i < n_lanes; i += L) {  // uniform across the lane's warps
    const int c = b + i * G;
    int32_t* chosen_c = chosen + (size_t)c * K;
    if (jw == 0)
      for (int k = lane; k < K; k += 32) chosen_c[k] = -1;
    if (!cand_valid[c]) {
      if (jw == 0 && lane == 0) feasible[c] = 0;
      continue;
    }
    // stage the lane's slot rows and clear its overlay
    const size_t ck = (size_t)c * K;
    for (int x = gt; x < K * R; x += 32 * P) ls.req[x] = slot_req[ck * R + x];
    for (int x = gt; x < K * W; x += 32 * P) ls.tol[x] = slot_tol[ck * W + x];
    for (int x = gt; x < K * A; x += 32 * P) ls.saff[x] = slot_aff[ck * A + x];
    for (int x = gt; x < K; x += 32 * P) {
      ls.valid[x] = slot_valid[ck + x];
      ls.ent_idx[x] = -1;
    }
    for (int x = gt; x < (S + 31) / 32; x += 32 * P) ls.touched[x] = 0u;
    lane_sync<P>(j);  // rows staged, chosen cleared
    const bool feas =
        solve_lane<BEST_FIT, P, FIXED>(st, ls, j, jw, chosen_c, K, R, W, A, S);
    if (jw == 0 && lane == 0) feasible[c] = feas ? 1 : 0;
    lane_sync<P>(j);  // done with the rows before the next lane's
  }
}

using FfdKernel = decltype(&ffd_kernel<false, 1, true, true>);

// kKernels[fixed][statics in shared memory][variant]: B1, then B2 at
// P = 1, 2, 4, 8
#define FFD_VARIANTS(SMEM, FIXED)                                          \
  {                                                                        \
    ffd_kernel<false, 1, SMEM, FIXED>, ffd_kernel<true, 1, SMEM, FIXED>,   \
        ffd_kernel<true, 2, SMEM, FIXED>, ffd_kernel<true, 4, SMEM, FIXED>, \
        ffd_kernel<true, 8, SMEM, FIXED>                                   \
  }
const FfdKernel kKernels[2][2][kVariants] = {
    {FFD_VARIANTS(false, false), FFD_VARIANTS(true, false)},
    {FFD_VARIANTS(false, true), FFD_VARIANTS(true, true)}};
#undef FFD_VARIANTS

// The variant of (best_fit, P), or -1.
int variant_of(int best_fit, int P) {
  if (!best_fit) return P == 1 ? 0 : -1;
  switch (P) {
    case 1: return 1;
    case 2: return 2;
    case 4: return 3;
    case 8: return 4;
    default: return -1;
  }
}

bool fixed_shape(int R, int W, int A) {
  return R == kFixedR && W == kFixedW && A == kFixedA;
}

// Per instance and device: the dynamic shared memory allowed so far
// (cudaFuncSetAttribute runs only when a launch needs more), and the
// occupancy last computed, with the block shape it was computed for.
constexpr int kMaxDevices = 64;
struct InstanceState {
  int smem_allowed = 0;
  int threads = 0, smem = -1, per_sm = 0, sms = 0;
};
std::mutex g_mutex;
InstanceState g_state[2][2][kVariants][kMaxDevices];

// Blocks resident at once for one instance and block shape on the
// current device: raises the instance's shared-memory allowance, then
// reads CUDA's occupancy (registers, threads, shared memory) times the
// SMs, cached per shape. 0 with `err` set on failure.
int resident_blocks(int fixed, int in_smem, int variant, int threads,
                    int smem, cudaError_t* err) {
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  const void* fn =
      reinterpret_cast<const void*>(kKernels[fixed][in_smem][variant]);
  std::lock_guard<std::mutex> lock(g_mutex);
  InstanceState scratch;
  InstanceState& is =
      dev < kMaxDevices ? g_state[fixed][in_smem][variant][dev] : scratch;
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

}  // namespace

extern "C" {

// Largest dynamic shared memory a block of every instance may use on
// `device`, or -1 on error.
int ffd_max_dynamic_smem(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  int static_bytes = 0;
  for (int n = 0; n < 2; ++n)
    for (int m = 0; m < 2; ++m)
      for (int v = 0; v < kVariants; ++v) {
        cudaFuncAttributes attr;
        if (cudaFuncGetAttributes(
                &attr, reinterpret_cast<const void*>(kKernels[n][m][v])) !=
            cudaSuccess)
          return -1;
        if ((int)attr.sharedSizeBytes > static_bytes)
          static_bytes = (int)attr.sharedSizeBytes;
      }
  return optin - static_bytes;
}

// Blocks of the persistent grid for C lanes in a geometry: as many as are
// resident at once on the current device, at most one per L lanes; a
// negative cudaError_t on error.
int ffd_blocks(int C, int R, int W, int A, int best_fit, int lanes_per_block,
               int warps_per_lane, int statics_in_smem, int smem_bytes) {
  const int L = lanes_per_block;
  const int P = warps_per_lane;
  const int variant = variant_of(best_fit, P);
  if (C < 1 || L < 1 || variant < 0 || L > kMaxThreads / (32 * P) ||
      (P > 1 && L > kMaxNamedLanes) ||
      (statics_in_smem != 0 && statics_in_smem != 1) || smem_bytes < 0)
    return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  const int resident = resident_blocks(fixed_shape(R, W, A), statics_in_smem,
                                       variant, L * P * 32, smem_bytes, &err);
  if (err != cudaSuccess) return -(int)err;
  const int per_lanes = (int)(((long long)C + L - 1) / L);
  return per_lanes < resident ? per_lanes : resident;
}

// Launch B1 (best_fit=0) or B2 (best_fit=1) over C lanes in the geometry
// ops/ffd_kernels.launch_geometry picked: `lanes_per_block` lanes of
// `warps_per_lane` warps each, the statics in shared memory or read from
// device memory, and `smem_bytes` of dynamic shared memory, which must be
// what that geometry takes; the grid is ffd_blocks().
int ffd_launch(const float* slot_req, const uint8_t* slot_valid,
               const int32_t* slot_tol, const int32_t* slot_aff,
               const uint8_t* cand_valid, const float* spot_free,
               const int32_t* spot_count, const int32_t* spot_max_pods,
               const int32_t* spot_taints, const uint8_t* spot_ok,
               const int32_t* spot_aff, uint8_t* feasible, int32_t* chosen,
               int C, int K, int R, int W, int A, int S, int best_fit,
               int lanes_per_block, int warps_per_lane, int statics_in_smem,
               int smem_bytes, void* stream) {
  if (C <= 0) return (int)cudaSuccess;
  if (R < 1 || W < 0 || A < 0 || S < 0 || K < 0 ||
      variant_of(best_fit, warps_per_lane) < 0 || lanes_per_block < 1)
    return (int)cudaErrorInvalidValue;
  const long long want =
      4 * ((statics_in_smem ? statics_words(S, R, W, A) : 0) +
           (long long)lanes_per_block *
               lane_words(K, R, W, A, S, warps_per_lane));
  if (want != smem_bytes) return (int)cudaErrorInvalidValue;
  const int blocks = ffd_blocks(C, R, W, A, best_fit, lanes_per_block,
                                warps_per_lane, statics_in_smem, smem_bytes);
  if (blocks < 0) return -blocks;
  void* args[] = {&slot_req,    &slot_valid, &slot_tol,      &slot_aff,
                  &cand_valid,  &spot_free,  &spot_count,    &spot_max_pods,
                  &spot_taints, &spot_ok,    &spot_aff,      &feasible,
                  &chosen,      &C,          &K,             &R,
                  &W,           &A,          &S,             &lanes_per_block};
  const cudaError_t err = cudaLaunchKernel(
      reinterpret_cast<const void*>(
          kKernels[fixed_shape(R, W, A)][statics_in_smem]
                  [variant_of(best_fit, warps_per_lane)]),
      dim3(blocks), dim3(lanes_per_block * warps_per_lane * 32), args,
      (size_t)smem_bytes, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();  // clears a launch error
  return (int)(err != cudaSuccess ? err : last);
}

const char* ffd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
