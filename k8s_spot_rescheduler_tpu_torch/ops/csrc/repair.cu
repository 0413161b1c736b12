// Kernel B5: repair's partial pass and its rounds for Hopper (sm_90a),
// on the lanes the greedy passes left unproven.
//
// Replaces no Pallas kernel: the JAX package leaves solver/repair.py's
// plan_repair to XLA, and the port's plain version (solver/repair.py:
// best-fit's raw pass, then repair_from) launches some 15 small
// operations a slot and 100 a round over [C, R, S]. Semantics are
// plan_repair's before its validation, on the lanes `unproven` marks
// (valid lanes that first-fit and best-fit left unproven; every other
// lane writes -1, which the union never reads, since it keeps greedy's
// answer there and validation reports an invalid lane infeasible):
//
// 1. the partial best-fit pass: greedy.cuh's solve_lane<BEST_FIT=true>,
//    as B2 runs it; a valid pod that fits nowhere leaves -1 and the
//    later slots still place;
// 2. `rounds` rounds of _repair_round on the lane's overlay: the first
//    unplaced valid pod p; the placed pods q whose ejection would let p
//    take their node (resources and static words), the
//    (round % n_unlock)-th of them elected; q's first fit elsewhere (the
//    direct move), or with `chain` the depth-2 move through the
//    ((round / n_unlock) % n_r)-th eligible placed pod r and r's first
//    fit elsewhere; the exact affinity of each node a pod arrives on,
//    its resident bits OR those of the pods still there.
//
// Each f32 expression keeps _repair_round's order
// ((free + req_k) - req_p >= 0), elections go to the lowest index, and
// the pack's requests are integral f32 below 2**24, so the overlay's
// absolute values equal the plain delta carry's widened ones and the
// assignment is bit-identical to plan_repair's.
//
// What bounds it. As B2: each valid slot of the partial pass tests all
// S spots, and a round is a few K-wide warp steps and at most two
// first-fit scans over the S spots, so the time is the issue rate and
// shared-memory latency along one lane's serial chain, not device memory
// (a lane reads its K slot rows once and writes K indices).
//
// The design is B2's (greedy.cuh): the spot statics staged once per
// block (or read from device memory where they do not fit beside a
// lane), and per lane its slot rows, an overlay of the spots it touched
// and a touched bitmap, P warps a lane in the partial pass. The lanes
// sit in shared memory after the statics or, where one lane alone
// passes a block's shared memory (K in the thousands), in a
// device-memory workspace of grid x L lanes that the wrapper allocates,
// as B1-B4's do. The overlay
// holds K + rounds entries: slot k's is made by slot k, and a round makes
// at most one, for the one spot it can reach that holds no placed pod
// (q's target on a direct move, r's on a chain; q's node and r's node
// hold their pods' entries), so round i's is entry K + i. The slot rows
// are padded to K + rounds with invalid slots, so solve_lane runs over
// the overlay's width unchanged. After them the lane keeps its
// assignment [K] and each placed slot's entry [K]. The rounds run on the
// lane's first warp: 32 slots a ballot for the K-wide steps (popcount
// prefixes elect the rotating q and r, __reduce_or_sync folds the
// affinity words), B1's ballot over 32-spot windows for the first-fit
// scans, and a commit that touches at most three entries. The grid is
// B1-B4's persistent one; a block none of whose lanes is unproven writes
// its -1 rows and returns before staging.
//
// Interface: plain C functions, built with nvcc into a shared library
// and called through ctypes (ops/ffd_kernels.py). The launch runs on the
// given stream, allocates nothing and returns the launch's cudaError_t.

#include "greedy.cuh"

namespace {

constexpr int kWarpChoices = 4;  // P = 1, 2, 4, 8

// 32-bit words of one repair lane: greedy.cuh's Lane over K + rounds
// overlay entries (its slot rows padded to as many), then the assignment
// [K] and each slot's entry [K].
__host__ __device__ __forceinline__ long long repair_lane_words(
    int K, int rounds, int R, int W, int A, int S, int P) {
  const int E = K + rounds;
  return lane_words(E, R, W, A, S, P, AbsOverlay::words(E, R, A, 0)) +
         2LL * K;
}

// Warp-wide: the rounds of one lane on its overlay after the partial
// pass. `assign` [K] holds the partial pass's placements and ends with
// the repaired ones; E = K + rounds is the overlay's width.
template <bool FIXED, class Statics>
__device__ __forceinline__ void repair_rounds(
    const Statics& st, const Lane<AbsOverlay>& ls, int32_t* assign,
    int32_t* ent_of, const uint8_t* __restrict__ spot_ok, int K, int E,
    int R, int W, int A, int S, int rounds, int chain) {
  using Sl = Slot<FIXED>;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int nwin = (S + 31) / 32;
  const AbsOverlay& ov = ls.ov;

  // the entry of each placed slot's spot (entries are one a spot)
  for (int k = lane; k < K; k += 32) {
    const int s = assign[k];
    int e = -1;
    for (int x = 0; s >= 0 && x < E; ++x) {
      if (ls.ent_idx[x] == s) {
        e = x;
        break;
      }
    }
    ent_of[k] = e;
  }
  __syncwarp();

  // Slot k is placed, not on `off`, and its spot would take pod `in`
  // once k left it: resources ((free + req_k) - req_in >= 0, per
  // resource), the static words and readiness. Affinity is vetted for
  // the elected pod alone.
  auto admits = [&](int k, const Sl& in, int off) -> bool {
    if (k >= K) return false;
    const int s = assign[k];
    if (s < 0 || s == off) return false;
    const int e = ent_of[k];
    const float* req_k = ls.req + k * R;
    bool ok = spot_ok[s] != 0;
    each<Sl::MR>(R, [&](int r) {
      ok &= ov.free[r * E + e] + req_k[r] - in.req(r) >= 0.0f;
    });
    each<Sl::MW>(W, [&](int w) {
      ok &= (st.taint_at(w, s) & ~in.tol(w)) == 0;
    });
    return ok;
  };
  // how many slots `pred` holds for, and the want-th of them (0-based)
  auto count_of = [&](auto&& pred) -> int {
    int n = 0;
    for (int base = 0; base < K; base += 32)
      n += __popc(__ballot_sync(kFull, pred(base + lane)));
    return n;
  };
  auto nth_of = [&](auto&& pred, int want) -> int {
    for (int base = 0; base < K; base += 32) {
      const bool t = pred(base + lane);
      const unsigned m = __ballot_sync(kFull, t);
      const int n = __popc(m);
      if (want < n) {
        const unsigned hit =
            __ballot_sync(kFull, t && __popc(m & below) == want);
        return base + __ffs(hit) - 1;
      }
      want -= n;
    }
    return -1;
  };
  // the first spot that takes the pod of `sl`, x1 and x2 left out; -1
  auto first_fit = [&](const Sl& sl, int x1, int x2) -> int {
    for (int w = 0; w < nwin; ++w) {
      float slack;
      int ew;
      const int s = (w << 5) + lane;
      const bool fit = test_window(st, ls, w, sl, E, R, W, A, S, slack, ew) &&
                       s != x1 && s != x2;
      const unsigned m = __ballot_sync(kFull, fit);
      if (m != 0u) return (w << 5) + __ffs(m) - 1;
    }
    return -1;
  };
  // word a of node's affinity once slot `leaving` left it: the node's
  // resident bits OR those of the other pods assigned there
  auto aff_without = [&](int node, int leaving, int a) -> int32_t {
    unsigned bits = 0u;
    for (int k = lane; k < K; k += 32)
      if (k != leaving && assign[k] == node)
        bits |= (unsigned)ls.saff[k * A + a];
    return (int32_t)(__reduce_or_sync(kFull, bits) |
                     (unsigned)st.aff_at(a, node));
  };
  auto aff_clear = [&](const Sl& in, int node, int leaving) -> bool {
    bool ok = true;
    each<Sl::MA>(A, [&](int a) {
      ok &= (in.aff(a) & aff_without(node, leaving, a)) == 0;
    });
    return ok;
  };
  // the entry of spot s for a pod arriving in round i: the spot's own,
  // or entry K + i filled from the statics
  auto entry_for = [&](int s, int i) -> int {
    if ((ls.touched[s >> 5] >> (s & 31)) & 1u) return lookup_spot(ls, s, E);
    const int e = K + i;
    if (lane == 0) {
      for (int r = 0; r < R; ++r) ov.free[r * E + e] = st.free_at(r, s);
      ov.room[e] = st.room_at(s);
      for (int a = 0; a < A; ++a) ov.aff[a * E + e] = st.aff_at(a, s);
      ls.ent_idx[e] = s;
      ls.touched[s >> 5] |= 1u << (s & 31);
    }
    __syncwarp();
    return e;
  };

  for (int i = 0; i < rounds; ++i) {
    // p: the first unplaced valid slot. Without one, or without an
    // unlocker, the round changes nothing, and neither does any later
    // one (neither p nor the unlockers depend on the round's index).
    int p = -1;
    for (int base = 0; base < K && p < 0; base += 32) {
      const int k = base + lane;
      const unsigned m =
          __ballot_sync(kFull, k < K && ls.valid[k] && assign[k] < 0);
      if (m != 0u) p = base + __ffs(m) - 1;
    }
    if (p < 0) break;
    const Sl pod_p(ls.req + p * R, ls.tol + p * W, ls.saff + p * A);
    auto unlocks = [&](int k) { return admits(k, pod_p, -1); };
    const int n_unlock = count_of(unlocks);
    if (n_unlock == 0) break;
    const int q = nth_of(unlocks, i % n_unlock);
    const int sq = assign[q];
    const int eq = ent_of[q];
    const Sl pod_q(ls.req + q * R, ls.tol + q * W, ls.saff + q * A);
    if (!aff_clear(pod_p, sq, q)) continue;  // p may not join q's node
    int r = -1, sr = -1, er = -1, s3 = -1;
    const int s2 = first_fit(pod_q, sq, -1);
    if (s2 < 0) {  // q cannot move directly: the chain through r
      if (!chain) continue;
      auto eligible = [&](int k) { return admits(k, pod_q, sq); };
      const int n_r = count_of(eligible);
      if (n_r == 0) continue;
      r = nth_of(eligible, (i / n_unlock) % n_r);
      sr = assign[r];
      er = ent_of[r];
      const Sl pod_r(ls.req + r * R, ls.tol + r * W, ls.saff + r * A);
      s3 = first_fit(pod_r, sr, sq);
      if (s3 < 0 || !aff_clear(pod_q, sr, r)) continue;
    }
    // commit: the words of the nodes a pod arrives on are folded before
    // `assign` moves; lane 0 writes
    const float* req_p = ls.req + p * R;
    const float* req_q = ls.req + q * R;
    for (int a = 0; a < A; ++a) {
      const int32_t w = aff_without(sq, q, a);
      if (lane == 0) ov.aff[a * E + eq] = w | ls.saff[p * A + a];
    }
    if (r < 0) {  // direct: q -> s2, p -> q's node
      const int e2 = entry_for(s2, i);
      if (lane == 0) {
        for (int x = 0; x < R; ++x) {
          ov.free[x * E + eq] = ov.free[x * E + eq] + (req_q[x] - req_p[x]);
          ov.free[x * E + e2] = ov.free[x * E + e2] - req_q[x];
        }
        ov.room[e2] -= 1;
        for (int a = 0; a < A; ++a) ov.aff[a * E + e2] |= ls.saff[q * A + a];
        assign[q] = s2;
        ent_of[q] = e2;
      }
    } else {  // chain: r -> s3, q -> r's node, p -> q's node
      for (int a = 0; a < A; ++a) {
        const int32_t w = aff_without(sr, r, a);
        if (lane == 0) ov.aff[a * E + er] = w | ls.saff[q * A + a];
      }
      const int e3 = entry_for(s3, i);
      if (lane == 0) {
        const float* req_r = ls.req + r * R;
        for (int x = 0; x < R; ++x) {
          ov.free[x * E + eq] = ov.free[x * E + eq] + (req_q[x] - req_p[x]);
          ov.free[x * E + er] = ov.free[x * E + er] + (req_r[x] - req_q[x]);
          ov.free[x * E + e3] = ov.free[x * E + e3] - req_r[x];
        }
        ov.room[e3] -= 1;
        for (int a = 0; a < A; ++a) ov.aff[a * E + e3] |= ls.saff[r * A + a];
        assign[q] = sr;
        ent_of[q] = er;
        assign[r] = s3;
        ent_of[r] = e3;
      }
    }
    if (lane == 0) {
      assign[p] = sq;
      ent_of[p] = eq;
    }
    __syncwarp();
  }
}

// B5. A persistent grid of G blocks; block b stages the statics once,
// then its lane slot j (warps [j*P, (j+1)*P)) takes lanes
// c = b + G*(j + L*i), i = 0, 1, ...: an unproven lane runs the partial
// pass on its P warps and the rounds on its first, and writes its
// assignment row; any other lane writes -1.
template <int P, bool SMEM_STATICS, bool FIXED>
__global__ void __launch_bounds__(kMaxThreads)
repair_kernel(const float* __restrict__ slot_req,         // [C, K, R]
              const uint8_t* __restrict__ slot_valid,     // [C, K]
              const int32_t* __restrict__ slot_tol,       // [C, K, W]
              const int32_t* __restrict__ slot_aff,       // [C, K, A]
              const uint8_t* __restrict__ unproven,       // [C]
              const float* __restrict__ spot_free,        // [S, R]
              const int32_t* __restrict__ spot_count,     // [S]
              const int32_t* __restrict__ spot_max_pods,  // [S]
              const int32_t* __restrict__ spot_taints,    // [S, W]
              const uint8_t* __restrict__ spot_ok,        // [S]
              const int32_t* __restrict__ spot_aff,       // [S, A]
              int32_t* __restrict__ assign_out,           // [C, K]
              int32_t* __restrict__ lane_ws,  // [G*L lanes] or nullptr
              int C, int K, int R, int W, int A, int S, int L, int rounds,
              int chain) {
  extern __shared__ __align__(16) int32_t smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int G = gridDim.x;
  const int b = blockIdx.x;
  const int n_lanes = (C - b + G - 1) / G;  // lanes b, b+G, ... below C

  // a block of lanes that are all proven (or invalid) writes -1 rows
  int mine = 0;
  for (int i = tid; i < n_lanes; i += T) mine |= unproven[b + i * G];
  if (!__syncthreads_or(mine)) {
    for (int i = tid; i < n_lanes * K; i += T)
      assign_out[(size_t)(b + (i / K) * G) * K + i % K] = -1;
    return;
  }

  const Spots sp{spot_free, spot_count, spot_max_pods, spot_taints, spot_ok,
                 spot_aff};
  using Statics = typename std::conditional<SMEM_STATICS, SmemStatics,
                                            GlobalStatics>::type;
  Statics st;
  if constexpr (SMEM_STATICS) {
    st = stage_statics(smem, sp, 0, S, R, W, A);
  } else {
    st = global_statics(sp, 0, R, W, A);
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int j = warp / P;   // lane slot of the block
  const int jw = warp % P;  // warp within the lane
  const int gt = jw * 32 + lane;
  const int E = K + rounds;  // overlay entries
  const long long lw = repair_lane_words(K, rounds, R, W, A, S, P);

  // The lane loop over one lane slot carved from `lanes`, called with
  // shared memory or with the device-memory workspace, each call inlined
  // on its own as in greedy.cuh's greedy_kernel; only the generic
  // (!FIXED) instances compile the workspace call.
  auto run = [&](int32_t* lanes) {
    int32_t* base = lanes + (size_t)j * lw;
    const Lane<AbsOverlay> ls = carve<AbsOverlay>(base, E, R, W, A, S, P, 0);
    int32_t* assign = base + (lw - 2LL * K);
    int32_t* ent_of = assign + K;

    // uniform across the lane's warps
    for (int i = j; i < n_lanes; i += L) {
      const int c = b + i * G;
      int32_t* out = assign_out + (size_t)c * K;
      if (!unproven[c]) {
        if (jw == 0)
          for (int k = lane; k < K; k += 32) out[k] = -1;
        continue;
      }
      // stage the lane's slot rows, padded to E with invalid slots, and
      // clear its overlay and assignment
      const size_t ck = (size_t)c * K;
      for (int x = gt; x < E * R; x += 32 * P)
        ls.req[x] = x < K * R ? slot_req[ck * R + x] : 0.0f;
      for (int x = gt; x < E * W; x += 32 * P)
        ls.tol[x] = x < K * W ? slot_tol[ck * W + x] : 0;
      for (int x = gt; x < E * A; x += 32 * P)
        ls.saff[x] = x < K * A ? slot_aff[ck * A + x] : 0;
      for (int x = gt; x < E; x += 32 * P) {
        ls.valid[x] = x < K && slot_valid[ck + x];
        ls.ent_idx[x] = -1;
      }
      for (int x = gt; x < K; x += 32 * P) assign[x] = -1;
      for (int x = gt; x < (S + 31) / 32; x += 32 * P) ls.touched[x] = 0u;
      lane_sync<P>(j);  // rows staged
      solve_lane<true, P, FIXED>(st, ls, j, jw, assign, 0, E, R, W, A, S);
      lane_sync<P>(j);  // every warp's commits in place
      if (jw == 0) {
        repair_rounds<FIXED>(st, ls, assign, ent_of, spot_ok, K, E, R, W, A, S,
                             rounds, chain);
        for (int k = lane; k < K; k += 32) out[k] = assign[k];
      }
      lane_sync<P>(j);  // done with the lane's state before the next lane's
    }
  };
  if constexpr (!FIXED) {
    if (lane_ws != nullptr) {
      run(lane_ws + (size_t)b * L * lw);
      return;
    }
  }
  run(smem + (SMEM_STATICS ? statics_words(S, R, W, A) : 0));
}

using RepairKernel = decltype(&repair_kernel<1, true, true>);

// kKernels[fixed][statics in shared memory][log2 P]
#define B5(P, SMEM, FIXED) repair_kernel<P, SMEM, FIXED>
#define B5_WARPS(SMEM, FIXED)                                         \
  {                                                                   \
    B5(1, SMEM, FIXED), B5(2, SMEM, FIXED), B5(4, SMEM, FIXED),       \
        B5(8, SMEM, FIXED)                                            \
  }
const RepairKernel kKernels[2][2][kWarpChoices] = {
    {B5_WARPS(false, false), B5_WARPS(true, false)},
    {B5_WARPS(false, true), B5_WARPS(true, true)}};
#undef B5_WARPS
#undef B5

// log2 of P in 1, 2, 4, 8, or -1.
int warp_choice(int P) {
  switch (P) {
    case 1: return 0;
    case 2: return 1;
    case 4: return 2;
    case 8: return 3;
    default: return -1;
  }
}

// The FIXED instances take the fixed R/W/A with the lanes in shared
// memory; lanes in the workspace take the generic ones.
int fixed_shape(int R, int W, int A, int lanes_in_ws) {
  return R == kFixedR && W == kFixedW && A == kFixedA && !lanes_in_ws;
}

std::mutex g_mutex;
InstanceState g_state[2][2][kWarpChoices][kMaxDevices];

}  // namespace

extern "C" {

// Largest dynamic shared memory a block of every instance may use on
// `device`, or -1 on error.
int repair_max_dynamic_smem(int device) {
  const void* fns[2 * 2 * kWarpChoices];
  int n = 0;
  for (int f = 0; f < 2; ++f)
    for (int m = 0; m < 2; ++m)
      for (int p = 0; p < kWarpChoices; ++p)
        fns[n++] = reinterpret_cast<const void*>(kKernels[f][m][p]);
  return max_dynamic_smem(device, fns, n);
}

// Blocks of B5's persistent grid for C lanes in a geometry
// (`lanes_in_ws` 1 when the lanes live in the device-memory workspace),
// as ffd_blocks(); a negative cudaError_t on error.
int repair_blocks(int C, int R, int W, int A, int lanes_per_block,
                  int warps_per_lane, int statics_in_smem, int smem_bytes,
                  int lanes_in_ws) {
  const int L = lanes_per_block;
  const int P = warps_per_lane;
  const int choice = warp_choice(P);
  if (C < 1 || L < 1 || choice < 0 || L > kMaxThreads / (32 * P) ||
      (P > 1 && L > kMaxNamedLanes) ||
      (statics_in_smem != 0 && statics_in_smem != 1) || smem_bytes < 0 ||
      (lanes_in_ws != 0 && lanes_in_ws != 1))
    return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  const int fixed = fixed_shape(R, W, A, lanes_in_ws);
  const int resident = resident_blocks(
      reinterpret_cast<const void*>(kKernels[fixed][statics_in_smem][choice]),
      g_state[fixed][statics_in_smem][choice], g_mutex, L * P * 32,
      smem_bytes, &err);
  if (err != cudaSuccess) return -(int)err;
  return grid_of(C, L, resident);
}

// Launch B5 over C lanes: `rounds` repair rounds (`chain` 1 for the
// depth-2 move) after the partial pass, on the lanes `unproven` marks,
// into `assign` [C, K] (-1 on every other lane), in the geometry
// ops/ffd_kernels.repair_geometry picked: `lanes_per_block` lanes of
// `warps_per_lane` warps each, the statics in shared memory or read from
// device memory, and `smem_bytes` of dynamic shared memory, which must be
// what that geometry takes; the grid is repair_blocks(). `lane_ws` is
// null, or, where one lane's state passes a block's shared memory, a
// device-memory workspace of `lane_ws_words` 32-bit words holding the
// grid's lanes (blocks x lanes_per_block x lane words); `smem_bytes`
// then counts no lane.
int repair_launch(const float* slot_req, const uint8_t* slot_valid,
                  const int32_t* slot_tol, const int32_t* slot_aff,
                  const uint8_t* unproven, const float* spot_free,
                  const int32_t* spot_count, const int32_t* spot_max_pods,
                  const int32_t* spot_taints, const uint8_t* spot_ok,
                  const int32_t* spot_aff, int32_t* assign, int32_t* lane_ws,
                  int C, int K, int R, int W, int A, int S, int rounds,
                  int chain, int lanes_per_block, int warps_per_lane,
                  int statics_in_smem, int smem_bytes, int lane_ws_words,
                  void* stream) {
  if (C <= 0) return (int)cudaSuccess;
  if (R < 1 || W < 0 || A < 0 || S < 1 || K < 1 || rounds < 0 ||
      (chain != 0 && chain != 1) || warp_choice(warps_per_lane) < 0 ||
      lanes_per_block < 1)
    return (int)cudaErrorInvalidValue;
  const long long lw =
      repair_lane_words(K, rounds, R, W, A, S, warps_per_lane);
  const int in_ws = lane_ws != nullptr;
  const long long want =
      4 * ((statics_in_smem ? statics_words(S, R, W, A) : 0) +
           (in_ws ? 0LL : lanes_per_block * lw));
  if (want != smem_bytes) return (int)cudaErrorInvalidValue;
  const int blocks =
      repair_blocks(C, R, W, A, lanes_per_block, warps_per_lane,
                    statics_in_smem, smem_bytes, in_ws);
  if (blocks < 0) return -blocks;
  if (in_ws && (long long)blocks * lanes_per_block * lw > lane_ws_words)
    return (int)cudaErrorInvalidValue;
  void* args[] = {&slot_req,    &slot_valid, &slot_tol,   &slot_aff,
                  &unproven,    &spot_free,  &spot_count, &spot_max_pods,
                  &spot_taints, &spot_ok,    &spot_aff,   &assign,
                  &lane_ws,     &C,          &K,          &R,
                  &W,           &A,          &S,          &lanes_per_block,
                  &rounds,      &chain};
  const cudaError_t err = cudaLaunchKernel(
      reinterpret_cast<const void*>(
          kKernels[fixed_shape(R, W, A, in_ws)][statics_in_smem]
                  [warp_choice(warps_per_lane)]),
      dim3(blocks), dim3(lanes_per_block * warps_per_lane * 32), args,
      (size_t)smem_bytes, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();  // clears a launch error
  return (int)(err != cudaSuccess ? err : last);
}

const char* repair_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
