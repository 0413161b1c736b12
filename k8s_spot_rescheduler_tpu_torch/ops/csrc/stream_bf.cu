// Kernel B4: the fused best-fit stream solve over the narrow delta
// carry, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel k8s_spot_rescheduler_tpu/ops/pallas_ffd.py
// `_stream_kernel`, entered there through `plan_stream_bf_pallas` and
// `_invoke_kernel(stream_layout=)`. Semantics are those of
// solver/ffd.plan_ffd_streamed(best_fit=True), which equal
// plan_ffd(best_fit=True) at every chunk count: every candidate lane is
// an independent fork of the spot pool; its K pod slots are placed in
// order, each on the fitting spot of least primary-resource slack, ties
// to the lowest index; a lane is feasible when every valid slot placed.
// The lane's state is the DELTA carry of a CarryLayout (solver/carry.py)
// in the layout's own dtypes, as the TPU kernel holds it: capacity
// consumed `used` (int16, uint16 or f32), placements added `dcount`
// (int8, int16 or int32) and placed pods' affinity bits `daff` (uint8,
// uint16 or uint32), widened against the statics on read
// (free = free0 - (float)used, count = count0 + dcount, aff = aff0 |
// daff) and narrowed on store (used += (UsedT)req, dcount += 1,
// daff |= (AffT)slot_aff), exact within the layout's guard.
//
// Bound. The same operations as B2: per valid slot a lane tests all S
// spots at R+W+A+5 operations each, so it is bound by instruction issue
// and shared-memory loads, not by device memory. The design is B2's
// (greedy.cuh), with the delta carry as the overlay's entries
// (DeltaOverlay): the spot statics staged once per block and shared by
// its lanes (read from device memory where they do not fit, with the
// overlay still in shared memory), and per lane only an overlay of up to
// K touched-spot entries (spot index, used[R], dcount, daff[A] in the
// layout's dtypes) plus a touched bitmap of ceil(S/32) words, so the
// layout sizes K entries, not S planes: at config 3 (int16/int8/uint8,
// K=32, R=4, A=2) 352 B of entries where the carry over every spot took
// 28.2 KB; no workspace. A test reads the statics and widens them
// against its entry only where the spot's bit is set; P warps a lane
// elect the least (slack, index) with two __reduce_min_sync and one
// named barrier a slot. The dtypes are codes read at run time, as
// block-uniform branches on an entry's load and store, so the instances
// are B2's geometry axes alone: P = 1, 2, 4, 8, the statics in shared or
// device memory, R/W/A = 4/1/2 fixed or not (16).
//
// Interface: plain C functions, built with nvcc into a shared library
// and called through ctypes (ops/ffd_kernels.py). The launch runs on the
// given stream, allocates nothing and returns the launch's cudaError_t.

#include "greedy.cuh"

namespace {

constexpr int kWarpChoices = 4;  // P = 1, 2, 4, 8
constexpr int kCodes = 3;        // dtype choices of each plane

using StreamKernel =
    decltype(&greedy_kernel<true, 1, true, true, DeltaOverlay>);

// kKernels[fixed][statics in shared memory][log2 P]
#define B4(P, SMEM, FIXED) greedy_kernel<true, P, SMEM, FIXED, DeltaOverlay>
#define B4_WARPS(SMEM, FIXED)                                         \
  {                                                                   \
    B4(1, SMEM, FIXED), B4(2, SMEM, FIXED), B4(4, SMEM, FIXED),       \
        B4(8, SMEM, FIXED)                                            \
  }
const StreamKernel kKernels[2][2][kWarpChoices] = {
    {B4_WARPS(false, false), B4_WARPS(true, false)},
    {B4_WARPS(false, true), B4_WARPS(true, true)}};
#undef B4_WARPS
#undef B4

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

bool valid_codes(int u, int n, int a) {
  return u >= 0 && u < kCodes && n >= 0 && n < kCodes && a >= 0 && a < kCodes;
}

std::mutex g_mutex;
InstanceState g_state[2][2][kWarpChoices][kMaxDevices];

}  // namespace

extern "C" {

// Largest dynamic shared memory a block of every instance may use on
// `device`, or -1 on error.
int stream_bf_max_dynamic_smem(int device) {
  const void* fns[2 * 2 * kWarpChoices];
  int n = 0;
  for (int f = 0; f < 2; ++f)
    for (int m = 0; m < 2; ++m)
      for (int p = 0; p < kWarpChoices; ++p)
        fns[n++] = reinterpret_cast<const void*>(kKernels[f][m][p]);
  return max_dynamic_smem(device, fns, n);
}

// Blocks of B4's persistent grid for C lanes in a geometry, as
// ffd_blocks(); a negative cudaError_t on error.
int stream_bf_blocks(int C, int R, int W, int A, int lanes_per_block,
                     int warps_per_lane, int statics_in_smem,
                     int smem_bytes, int lanes_in_ws) {
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

// Launch B4 over C lanes with the overlay's entries in the dtypes of the
// codes (ops/ffd_kernels.USED_CODES, COUNT_CODES, AFF_CODES), in the
// geometry ops/ffd_kernels.launch_geometry picked for the layout:
// `lanes_per_block` lanes of `warps_per_lane` warps each, the statics in
// shared memory or read from device memory, and `smem_bytes` of dynamic
// shared memory, which must be what that geometry takes; the grid is
// stream_bf_blocks(). `lane_ws` is null or the lanes' device-memory
// workspace of `lane_ws_words` words, as in ffd_launch().
int stream_bf_launch(const float* slot_req, const uint8_t* slot_valid,
                     const int32_t* slot_tol, const int32_t* slot_aff,
                     const uint8_t* cand_valid, const float* spot_free,
                     const int32_t* spot_count, const int32_t* spot_max_pods,
                     const int32_t* spot_taints, const uint8_t* spot_ok,
                     const int32_t* spot_aff, uint8_t* feasible,
                     int32_t* chosen, int32_t* lane_ws, int C, int K, int R,
                     int W, int A, int S,
                     int used_code, int count_code, int aff_code,
                     int lanes_per_block, int warps_per_lane,
                     int statics_in_smem, int smem_bytes, int lane_ws_words,
                     void* stream) {
  if (C <= 0) return (int)cudaSuccess;
  if (R < 1 || W < 0 || A < 0 || S < 0 || K < 0 ||
      !valid_codes(used_code, count_code, aff_code) ||
      warp_choice(warps_per_lane) < 0 || lanes_per_block < 1)
    return (int)cudaErrorInvalidValue;
  int codes = used_code | count_code << 8 | aff_code << 16;
  // one lane's words; the lanes take shared memory unless in lane_ws
  const long long lw =
      lane_words(K, R, W, A, S, warps_per_lane,
                 DeltaOverlay::words(K, R, A, codes));
  const long long want =
      4 * ((statics_in_smem ? statics_words(S, R, W, A) : 0) +
           (lane_ws != nullptr ? 0LL : lanes_per_block * lw));
  if (want != smem_bytes) return (int)cudaErrorInvalidValue;
  const int in_ws = lane_ws != nullptr;
  const int blocks =
      stream_bf_blocks(C, R, W, A, lanes_per_block, warps_per_lane,
                       statics_in_smem, smem_bytes, in_ws);
  if (blocks < 0) return -blocks;
  if (lane_ws != nullptr && blocks * lanes_per_block * lw > lane_ws_words)
    return (int)cudaErrorInvalidValue;
  int spot_chunk = S > 0 ? S : 1;  // one chunk
  void* args[] = {&slot_req,    &slot_valid, &slot_tol,      &slot_aff,
                  &cand_valid,  &spot_free,  &spot_count,    &spot_max_pods,
                  &spot_taints, &spot_ok,    &spot_aff,      &feasible,
                  &chosen,      &lane_ws,    &C,             &K,
                  &R,           &W,          &A,             &S,
                  &spot_chunk,  &lanes_per_block,            &codes};
  const cudaError_t err = cudaLaunchKernel(
      reinterpret_cast<const void*>(
          kKernels[fixed_shape(R, W, A, in_ws)][statics_in_smem]
                  [warp_choice(warps_per_lane)]),
      dim3(blocks), dim3(lanes_per_block * warps_per_lane * 32), args,
      (size_t)smem_bytes, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();  // clears a launch error
  return (int)(err != cudaSuccess ? err : last);
}

const char* stream_bf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
