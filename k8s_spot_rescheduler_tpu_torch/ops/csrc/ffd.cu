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
// valid slot placed.
//
// Design. One thread block per candidate lane. The lane's mutable state
// -- free capacity f32 [R][S], pod count i32 [S] and affinity words
// i32 [A][S] -- lives in dynamic shared memory for all K steps (at the
// north-star shape S=2560, R=4, A=2 that is 71.7 KB, three blocks per
// SM); where it does not fit, the same code keeps it in a global
// workspace the wrapper allocates. Threads stride the spot axis. At each
// valid slot every thread tests its spots, keeps its best candidate, and
// a block-wide reduction elects the winner (min index; or min slack,
// then min index). Thread 0 commits the placement. Invalid slots change
// nothing and are skipped, which also stops each lane at its last valid
// slot (the reference's `kmax`). Lanes with cand_valid=0 write
// feasible=0 and chosen=-1 and do no work: every consumer masks them.
//
// Bound. Per lane and valid slot the block reads S*(R+1+A) words of its
// state and S*(1+W+1) static words (L2-resident), so the kernel is
// bound by shared-memory and instruction throughput, not by device
// memory: the inputs it must read once are a few MB. The slacks are
// integral f32, so the best-fit election is exact.
//
// Interface: a plain C function, built with nvcc into a shared library
// and called through ctypes (ops/ffd_kernels.py). It launches on the
// given stream, allocates nothing and returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWords = 32;  // cap on R, W and A (staged per slot)

struct Best {
  float slack;
  int idx;
};

// lexicographic (slack, idx) minimum; first-fit carries slack = 0
__device__ __forceinline__ Best better(Best a, Best b) {
  if (b.slack < a.slack || (b.slack == a.slack && b.idx < a.idx)) return b;
  return a;
}

template <bool BEST_FIT>
__global__ void __launch_bounds__(kThreads)
ffd_lane_kernel(const float* __restrict__ slot_req,          // [C, K, R]
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
                int32_t* __restrict__ workspace,  // [C, R+1+A, S] or null
                int K, int R, int W, int A, int S) {
  extern __shared__ __align__(16) int32_t smem_state[];
  __shared__ float req_sh[kMaxWords];
  __shared__ int32_t tol_sh[kMaxWords];
  __shared__ int32_t aff_sh[kMaxWords];
  __shared__ Best red[kWarps];

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  int32_t* chosen_c = chosen + (size_t)c * K;
  for (int k = tid; k < K; k += kThreads) chosen_c[k] = -1;
  if (!cand_valid[c]) {
    if (tid == 0) feasible[c] = 0;
    return;
  }

  int32_t* state = workspace != nullptr
                       ? workspace + (size_t)c * (R + 1 + A) * S
                       : smem_state;
  float* free_ = reinterpret_cast<float*>(state);  // [R][S]
  int32_t* count_ = state + (size_t)R * S;         // [S]
  int32_t* aff_ = count_ + S;                      // [A][S]

  // fork: the lane's private copy of the spot pool
  for (int s = tid; s < S; s += kThreads) {
    for (int r = 0; r < R; ++r) free_[r * S + s] = spot_free[(size_t)s * R + r];
    count_[s] = spot_count[s];
    for (int a = 0; a < A; ++a) aff_[a * S + s] = spot_aff[(size_t)s * A + a];
  }
  bool feas = true;  // meaningful in thread 0

  for (int k = 0; k < K; ++k) {
    const size_t ck = (size_t)c * K + k;
    if (!slot_valid[ck]) continue;  // uniform across the block
    if (tid < R) req_sh[tid] = slot_req[ck * R + tid];
    if (tid < W) tol_sh[tid] = slot_tol[ck * W + tid];
    if (tid < A) aff_sh[tid] = slot_aff[ck * A + tid];
    __syncthreads();  // state init / previous commit and slot staged

    Best best{__int_as_float(0x7f800000), INT_MAX};  // (+inf, none)
    for (int s = tid; s < S; s += kThreads) {
      bool fit = spot_ok[s] != 0 && count_[s] < spot_max_pods[s];
      for (int r = 0; fit && r < R; ++r) fit = free_[r * S + s] >= req_sh[r];
      for (int w = 0; fit && w < W; ++w)
        fit = (spot_taints[(size_t)s * W + w] & ~tol_sh[w]) == 0;
      for (int a = 0; fit && a < A; ++a) fit = (aff_[a * S + s] & aff_sh[a]) == 0;
      if (!fit) continue;
      if (BEST_FIT) {
        const float slack = free_[s] - req_sh[0];
        if (slack < best.slack) best = Best{slack, s};  // s ascends: ties keep the first
      } else {
        best = Best{0.0f, s};
        break;  // this thread's spots ascend: its first fit is its best
      }
    }
    // block-wide election: warp shuffles, then warp 0 over the warps
    for (int off = 16; off > 0; off >>= 1) {
      Best other{__shfl_down_sync(0xffffffffu, best.slack, off),
                 __shfl_down_sync(0xffffffffu, best.idx, off)};
      best = better(best, other);
    }
    if ((tid & 31) == 0) red[tid >> 5] = best;
    __syncthreads();
    if (tid < 32) {
      best = tid < kWarps ? red[tid] : Best{__int_as_float(0x7f800000), INT_MAX};
      for (int off = 16; off > 0; off >>= 1) {
        Best other{__shfl_down_sync(0xffffffffu, best.slack, off),
                   __shfl_down_sync(0xffffffffu, best.idx, off)};
        best = better(best, other);
      }
      if (tid == 0) {
        const int s = best.idx;
        if (s != INT_MAX) {  // commit into the fork
          for (int r = 0; r < R; ++r) free_[r * S + s] -= req_sh[r];
          count_[s] += 1;
          for (int a = 0; a < A; ++a) aff_[a * S + s] |= aff_sh[a];
          chosen_c[k] = s;
        } else {
          feas = false;  // a valid pod fits nowhere
        }
      }
    }
    __syncthreads();  // commit visible before the next slot's tests
  }
  if (tid == 0) feasible[c] = feas ? 1 : 0;
}

// The dynamic shared memory each kernel instance is allowed, per device:
// cudaFuncSetAttribute runs only when a launch needs more than was set.
constexpr int kMaxDevices = 64;
std::mutex g_smem_mutex;
int g_smem_allowed[2][kMaxDevices] = {};

template <bool BEST_FIT>
cudaError_t allow_smem(size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(g_smem_mutex);
  int* allowed = dev < kMaxDevices ? &g_smem_allowed[BEST_FIT][dev] : nullptr;
  if (allowed != nullptr && (int)smem <= *allowed) return cudaSuccess;
  err = cudaFuncSetAttribute(ffd_lane_kernel<BEST_FIT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && allowed != nullptr) *allowed = (int)smem;
  return err;
}

}  // namespace

extern "C" {

// Bytes of per-lane state the kernel keeps in shared memory.
long long ffd_state_bytes(int R, int A, int S) {
  return (long long)(R + 1 + A) * S * 4;
}

// Largest dynamic shared memory a block of the kernel may use on
// `device`, or -1 on error.
int ffd_max_dynamic_smem(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, ffd_lane_kernel<false>) != cudaSuccess) return -1;
  int static_bytes = (int)attr.sharedSizeBytes;
  if (cudaFuncGetAttributes(&attr, ffd_lane_kernel<true>) != cudaSuccess) return -1;
  if ((int)attr.sharedSizeBytes > static_bytes) static_bytes = (int)attr.sharedSizeBytes;
  return optin - static_bytes;
}

// Launch B1 (best_fit=0) or B2 (best_fit=1) over C lanes. `workspace`
// is null to hold the lane state in shared memory, else an int32 buffer
// of C*(R+1+A)*S words in device memory.
int ffd_launch(const float* slot_req, const uint8_t* slot_valid,
               const int32_t* slot_tol, const int32_t* slot_aff,
               const uint8_t* cand_valid, const float* spot_free,
               const int32_t* spot_count, const int32_t* spot_max_pods,
               const int32_t* spot_taints, const uint8_t* spot_ok,
               const int32_t* spot_aff, uint8_t* feasible, int32_t* chosen,
               int32_t* workspace, int C, int K, int R, int W, int A, int S,
               int best_fit, void* stream) {
  if (C <= 0) return (int)cudaSuccess;
  if (R < 1 || R > kMaxWords || W < 0 || W > kMaxWords || A < 0 ||
      A > kMaxWords || S < 0 || K < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = workspace != nullptr ? 0 : (size_t)ffd_state_bytes(R, A, S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (best_fit) {
    err = allow_smem<true>(smem);
    if (err != cudaSuccess) return (int)err;
    ffd_lane_kernel<true><<<C, kThreads, smem, st>>>(
        slot_req, slot_valid, slot_tol, slot_aff, cand_valid, spot_free,
        spot_count, spot_max_pods, spot_taints, spot_ok, spot_aff, feasible,
        chosen, workspace, K, R, W, A, S);
  } else {
    err = allow_smem<false>(smem);
    if (err != cudaSuccess) return (int)err;
    ffd_lane_kernel<false><<<C, kThreads, smem, st>>>(
        slot_req, slot_valid, slot_tol, slot_aff, cand_valid, spot_free,
        spot_count, spot_max_pods, spot_taints, spot_ok, spot_aff, feasible,
        chosen, workspace, K, R, W, A, S);
  }
  return (int)cudaGetLastError();
}

const char* ffd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
