// Kernels B1 (first-fit), B2 (best-fit) and B3 (first-fit over spot
// chunks): the batched greedy drain solve for Hopper (sm_90a); B1t and
// B2t are B1 and B2 launched over T stacked problems of one shape, the
// planner service's batch (gridDim.y = T, greedy.cuh point 8).
//
// Replaces the Pallas TPU kernel k8s_spot_rescheduler_tpu/ops/pallas_ffd.py
// `_kernel` (best_fit=False / True), entered there through
// `plan_ffd_pallas` and `_invoke_kernel`, and its chunk loop
// `_plan_ffd_chunked`. Semantics are those of solver/ffd.plan_ffd: every
// candidate lane is an independent fork of the spot pool; its K pod
// slots are placed in order, each on the first fitting spot (B1) or on
// the fitting spot of least primary-resource slack, ties to the lowest
// index (B2); a lane is feasible when every valid slot placed. B3 is
// first-fit over ordered spot chunks, each chunk taking the pods still
// unplaced, which is exact for first-fit: a chunk's spots are touched
// only by its own placements, and first-fit prefers earlier spots. B1
// is B3 with one chunk. The raw outputs keep the placements of a lane
// after one of its slots failed; lanes with cand_valid=0 write
// feasible=0 and chosen=-1.
//
// What bounds it. Not device memory (the inputs are a few MB) and not
// arithmetic: each lane is a serial chain of K slots, and each slot is a
// search over the spot axis, so the time is the latency of that chain and
// the instructions each test costs. Measured at config 3 on one H100
// (PERF.md): B1 stays latency-bound, a slot being about one window whose
// chain of shared-memory reads, ballot and commit takes ~0.8 us; B2 is
// bound by instruction issue and shared-memory loads, since every slot
// tests all S spots (nine shared loads a window). The design, shared with
// B4 (greedy.cuh): spot statics staged once per block in shared memory
// (or read from device memory where they do not fit), a touched-spot
// overlay per lane instead of a fork of the pool, the slot rows staged,
// warp ballots for first-fit and one named barrier a slot for best-fit's
// election, a persistent grid sized by CUDA's occupancy. B3 walks its
// chunks inside one launch: the chunk is the block's outer loop, so a
// block stages each chunk's statics once (Sc spots, not S: more lanes fit
// a block, and a pool past shared memory can still be staged chunk by
// chunk), and only lanes with pods left re-stage their rows, while a
// block none of whose lanes has pods left stops. With the lane round
// outer instead, a block of several rounds would stage every chunk's
// statics once per round.
//
// Interface: plain C functions, built with nvcc into a shared library
// and called through ctypes (ops/ffd_kernels.py). The launch runs on the
// given stream, allocates nothing and returns the launch's cudaError_t.

#include "greedy.cuh"

namespace {

constexpr int kVariants = 5;  // first-fit, then best-fit with P = 1, 2, 4, 8
constexpr int kMaxTenants = 65535;  // gridDim.y

using FfdKernel = decltype(&greedy_kernel<false, 1, true, true, AbsOverlay>);

// kKernels[tenants][fixed][statics in shared memory][variant]: first-fit
// (B1, B3), then B2 at P = 1, 2, 4, 8; tenants 1 for the instances that
// solve blockIdx.y's problem (B1t/B2t with T > 1)
#define FFD(BF, P, SMEM, FIXED, TN) \
  greedy_kernel<BF, P, SMEM, FIXED, AbsOverlay, TN>
#define FFD_VARIANTS(SMEM, FIXED, TN)                                   \
  {                                                                     \
    FFD(false, 1, SMEM, FIXED, TN), FFD(true, 1, SMEM, FIXED, TN),      \
        FFD(true, 2, SMEM, FIXED, TN), FFD(true, 4, SMEM, FIXED, TN),   \
        FFD(true, 8, SMEM, FIXED, TN)                                   \
  }
#define FFD_SHAPES(TN)                                                  \
  {                                                                     \
    {FFD_VARIANTS(false, false, TN), FFD_VARIANTS(true, false, TN)},    \
        {FFD_VARIANTS(false, true, TN), FFD_VARIANTS(true, true, TN)}   \
  }
const FfdKernel kKernels[2][2][2][kVariants] = {FFD_SHAPES(false),
                                                FFD_SHAPES(true)};
#undef FFD_SHAPES
#undef FFD_VARIANTS
#undef FFD

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

// The FIXED instances take the fixed R/W/A with the lanes in shared
// memory; lanes in the workspace take the generic ones.
int fixed_shape(int R, int W, int A, int lanes_in_ws) {
  return R == kFixedR && W == kFixedW && A == kFixedA && !lanes_in_ws;
}

std::mutex g_mutex;
InstanceState g_state[2][2][2][kVariants][kMaxDevices];

}  // namespace

extern "C" {

// Largest dynamic shared memory a block of every instance may use on
// `device`, or -1 on error.
int ffd_max_dynamic_smem(int device) {
  const void* fns[2 * 2 * 2 * kVariants];
  int n = 0;
  for (int t = 0; t < 2; ++t)
    for (int f = 0; f < 2; ++f)
      for (int m = 0; m < 2; ++m)
        for (int v = 0; v < kVariants; ++v)
          fns[n++] = reinterpret_cast<const void*>(kKernels[t][f][m][v]);
  return max_dynamic_smem(device, fns, n);
}

// Blocks of the persistent grid of each of `tenants` stacked problems of
// C lanes in a geometry (`lanes_in_ws` 1 when the lanes live in the
// device-memory workspace): the blocks resident at once on the current
// device, split over the tenants, at least one and at most one per L
// lanes; a negative cudaError_t on error.
int ffd_blocks(int C, int R, int W, int A, int best_fit, int lanes_per_block,
               int warps_per_lane, int statics_in_smem, int smem_bytes,
               int lanes_in_ws, int tenants) {
  const int L = lanes_per_block;
  const int P = warps_per_lane;
  const int variant = variant_of(best_fit, P);
  if (C < 1 || L < 1 || variant < 0 || L > kMaxThreads / (32 * P) ||
      (P > 1 && L > kMaxNamedLanes) ||
      (statics_in_smem != 0 && statics_in_smem != 1) || smem_bytes < 0 ||
      (lanes_in_ws != 0 && lanes_in_ws != 1) || tenants < 1 ||
      tenants > kMaxTenants)
    return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  const int tn = tenants > 1;
  const int fixed = fixed_shape(R, W, A, lanes_in_ws);
  const int resident = resident_blocks(
      reinterpret_cast<const void*>(
          kKernels[tn][fixed][statics_in_smem][variant]),
      g_state[tn][fixed][statics_in_smem][variant], g_mutex, L * P * 32,
      smem_bytes, &err);
  if (err != cudaSuccess) return -(int)err;
  const int per_tenant = resident / tenants;
  return grid_of(C, L, per_tenant > 0 ? per_tenant : 1);
}

// Launch B1/B3 (best_fit=0) or B2 (best_fit=1) over C lanes of each of
// `tenants` stacked problems (B1t/B2t, on the instances that read
// blockIdx.y; 1 for one problem, on those that do not), grid
// ffd_blocks() x tenants, in the geometry ops/ffd_kernels.launch_geometry
// picked for spot chunks of `spot_chunk` spots (>= S: one chunk;
// best-fit takes one chunk only): `lanes_per_block` lanes of `warps_per_lane` warps each, a chunk's
// statics in shared memory or read from device memory, and `smem_bytes`
// of dynamic shared memory, which must be what that geometry takes; the
// grid is ffd_blocks(). `lane_ws` is null, or, where one lane's state
// passes a block's shared memory, a device-memory workspace of
// `lane_ws_words` 32-bit words holding the grid's lanes (blocks x
// lanes_per_block x tenants x lane_words); `smem_bytes` then counts no
// lane.
int ffd_launch(const float* slot_req, const uint8_t* slot_valid,
               const int32_t* slot_tol, const int32_t* slot_aff,
               const uint8_t* cand_valid, const float* spot_free,
               const int32_t* spot_count, const int32_t* spot_max_pods,
               const int32_t* spot_taints, const uint8_t* spot_ok,
               const int32_t* spot_aff, uint8_t* feasible, int32_t* chosen,
               int32_t* lane_ws, int C, int K, int R, int W, int A, int S,
               int spot_chunk, int best_fit, int lanes_per_block,
               int warps_per_lane, int statics_in_smem, int smem_bytes,
               int lane_ws_words, int tenants, void* stream) {
  if (C <= 0) return (int)cudaSuccess;
  if (R < 1 || W < 0 || A < 0 || S < 0 || K < 0 || spot_chunk < 1 ||
      (best_fit && spot_chunk < S) ||
      variant_of(best_fit, warps_per_lane) < 0 || lanes_per_block < 1)
    return (int)cudaErrorInvalidValue;
  const int Sw = S < spot_chunk ? S : spot_chunk;
  // one lane's words; the lanes take shared memory unless in lane_ws
  const long long lw =
      lane_words(K, R, W, A, Sw, warps_per_lane, AbsOverlay::words(K, R, A, 0));
  const long long want =
      4 * ((statics_in_smem ? statics_words(Sw, R, W, A) : 0) +
           (lane_ws != nullptr ? 0LL : lanes_per_block * lw));
  if (want != smem_bytes) return (int)cudaErrorInvalidValue;
  const int in_ws = lane_ws != nullptr;
  const int blocks = ffd_blocks(C, R, W, A, best_fit, lanes_per_block,
                                warps_per_lane, statics_in_smem, smem_bytes,
                                in_ws, tenants);
  if (blocks < 0) return -blocks;
  if (lane_ws != nullptr &&
      (long long)blocks * tenants * lanes_per_block * lw > lane_ws_words)
    return (int)cudaErrorInvalidValue;
  int codes = 0;
  void* args[] = {&slot_req,    &slot_valid, &slot_tol,      &slot_aff,
                  &cand_valid,  &spot_free,  &spot_count,    &spot_max_pods,
                  &spot_taints, &spot_ok,    &spot_aff,      &feasible,
                  &chosen,      &lane_ws,    &C,             &K,
                  &R,           &W,          &A,             &S,
                  &spot_chunk,  &lanes_per_block,            &codes};
  const cudaError_t err = cudaLaunchKernel(
      reinterpret_cast<const void*>(
          kKernels[tenants > 1][fixed_shape(R, W, A, in_ws)][statics_in_smem]
                  [variant_of(best_fit, warps_per_lane)]),
      dim3(blocks, tenants), dim3(lanes_per_block * warps_per_lane * 32), args,
      (size_t)smem_bytes, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();  // clears a launch error
  return (int)(err != cudaSuccess ? err : last);
}

const char* ffd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
