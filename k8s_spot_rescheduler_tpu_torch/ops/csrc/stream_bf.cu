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
//
// Design. One thread block per candidate lane, as B2 (ffd.cu). The
// lane's mutable state is only the DELTA carry of a CarryLayout
// (solver/carry.py), in the layout's own dtypes: capacity consumed
// `used` [R][S] (int16, uint16 or f32), placements added `dcount` [S]
// (int8, int16 or int32) and placed pods' affinity bits `daff` [A][S]
// (uint8, uint16 or uint32), each plane 16-byte aligned in dynamic
// shared memory. The fork is a memset: the static spot rows are never
// copied. They are read from device memory (L2-resident, shared by
// every block) at each test and widened against the deltas:
// free = free0 - used, count = count0 + dcount, aff = aff0 | daff. The
// election is B2's: every thread keeps its (slack, index) minimum over
// the spots it strides, and warp shuffles then warp 0 elect the block's
// lexicographic minimum -- exact, since slacks are integral f32. Thread
// 0 commits into the deltas, narrowing on store (exact within the
// layout's guard). Invalid slots are skipped; lanes with cand_valid=0
// write feasible=0 and chosen=-1 and do no work. Where the carry does
// not fit a block's shared memory, the same code keeps it in a device
// workspace the wrapper allocates, in the same dtypes.
//
// Bound. The same operations as B2: per valid slot the block tests all
// S spots at R+W+A+5 operations each, so it is bound by instruction and
// load throughput, not by device memory. What changes is the resident
// state: plane_bytes(layout) per spot instead of 4*(R+1+A) -- 11 B
// against 28 B at config 3 (int16/int8/uint8, R=4, A=2), 28.2 KB a lane
// at S=2560 instead of 71.7 KB -- so about eight blocks fit an SM's
// shared memory instead of three, paid for by reading the statics from
// L2 at every test instead of from shared memory.
//
// Interface: plain C functions, built with nvcc into a shared library
// and called through ctypes (ops/ffd_kernels.py). The launch runs on the
// given stream, allocates nothing and returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWords = 32;  // cap on R, W and A (staged per slot)
constexpr int kCodes = 3;      // dtype choices of each plane

struct Best {
  float slack;
  int idx;
};

// lexicographic (slack, idx) minimum
__device__ __forceinline__ Best better(Best a, Best b) {
  if (b.slack < a.slack || (b.slack == a.slack && b.idx < a.idx)) return b;
  return a;
}

__host__ __device__ __forceinline__ size_t align16(size_t bytes) {
  return (bytes + 15) & ~static_cast<size_t>(15);
}

// bytes of one lane's carry: R used planes, the count plane, A aff planes
__host__ __device__ __forceinline__ size_t lane_bytes(int R, int A, int S,
                                                      size_t used_size,
                                                      size_t count_size,
                                                      size_t aff_size) {
  return R * align16(S * used_size) + align16(S * count_size) +
         A * align16(S * aff_size);
}

template <typename UsedT, typename CountT, typename AffT>
__global__ void __launch_bounds__(kThreads)
stream_bf_kernel(const float* __restrict__ slot_req,         // [C, K, R]
                 const uint8_t* __restrict__ slot_valid,     // [C, K]
                 const int32_t* __restrict__ slot_tol,       // [C, K, W]
                 const int32_t* __restrict__ slot_aff,       // [C, K, A]
                 const uint8_t* __restrict__ cand_valid,     // [C]
                 const float* __restrict__ spot_free,        // [S, R]
                 const int32_t* __restrict__ spot_count,     // [S]
                 const int32_t* __restrict__ spot_max_pods,  // [S]
                 const int32_t* __restrict__ spot_taints,    // [S, W]
                 const uint8_t* __restrict__ spot_ok,        // [S]
                 const int32_t* __restrict__ spot_aff,       // [S, A]
                 uint8_t* __restrict__ feasible,             // [C]
                 int32_t* __restrict__ chosen,               // [C, K]
                 int32_t* __restrict__ workspace,  // C lane carries, or null
                 int K, int R, int W, int A, int S) {
  extern __shared__ __align__(16) unsigned char smem_carry[];
  __shared__ float req_sh[kMaxWords];
  __shared__ uint32_t tol_sh[kMaxWords];
  __shared__ uint32_t aff_sh[kMaxWords];
  __shared__ Best red[kWarps];

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  int32_t* chosen_c = chosen + (size_t)c * K;
  for (int k = tid; k < K; k += kThreads) chosen_c[k] = -1;
  if (!cand_valid[c]) {
    if (tid == 0) feasible[c] = 0;
    return;
  }

  const size_t used_pitch = align16((size_t)S * sizeof(UsedT));
  const size_t count_pitch = align16((size_t)S * sizeof(CountT));
  const size_t aff_pitch = align16((size_t)S * sizeof(AffT));
  const size_t bytes = lane_bytes(R, A, S, sizeof(UsedT), sizeof(CountT),
                                  sizeof(AffT));
  unsigned char* carry =
      workspace != nullptr
          ? reinterpret_cast<unsigned char*>(workspace) + (size_t)c * bytes
          : smem_carry;
  // the fork: every delta starts at zero (the statics are never copied)
  uint4* words = reinterpret_cast<uint4*>(carry);
  for (size_t i = tid; i < bytes / 16; i += kThreads)
    words[i] = make_uint4(0u, 0u, 0u, 0u);
  UsedT* used = reinterpret_cast<UsedT*>(carry);  // plane r at r * used_stride
  CountT* dcount = reinterpret_cast<CountT*>(carry + R * used_pitch);
  AffT* daff = reinterpret_cast<AffT*>(carry + R * used_pitch + count_pitch);
  const size_t used_stride = used_pitch / sizeof(UsedT);
  const size_t aff_stride = aff_pitch / sizeof(AffT);
  bool feas = true;  // meaningful in thread 0

  for (int k = 0; k < K; ++k) {
    const size_t ck = (size_t)c * K + k;
    if (!slot_valid[ck]) continue;  // uniform across the block
    if (tid < R) req_sh[tid] = slot_req[ck * R + tid];
    if (tid < W) tol_sh[tid] = (uint32_t)slot_tol[ck * W + tid];
    if (tid < A) aff_sh[tid] = (uint32_t)slot_aff[ck * A + tid];
    __syncthreads();  // carry zeroed / previous commit and slot staged

    Best best{__int_as_float(0x7f800000), INT_MAX};  // (+inf, none)
    for (int s = tid; s < S; s += kThreads) {
      if (!spot_ok[s]) continue;
      if (spot_count[s] + (int32_t)dcount[s] >= spot_max_pods[s]) continue;
      // widen on read: free = free0 - used (exact, integral f32)
      const float free0 = spot_free[(size_t)s * R] - (float)used[s];
      bool fit = free0 >= req_sh[0];
      for (int r = 1; fit && r < R; ++r)
        fit = spot_free[(size_t)s * R + r] - (float)used[r * used_stride + s] >=
              req_sh[r];
      for (int w = 0; fit && w < W; ++w)
        fit = ((uint32_t)spot_taints[(size_t)s * W + w] & ~tol_sh[w]) == 0u;
      for (int a = 0; fit && a < A; ++a)
        fit = (((uint32_t)spot_aff[(size_t)s * A + a] |
                (uint32_t)daff[a * aff_stride + s]) &
               aff_sh[a]) == 0u;
      if (!fit) continue;
      const float slack = free0 - req_sh[0];
      if (slack < best.slack) best = Best{slack, s};  // s ascends: ties keep the first
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
        if (s != INT_MAX) {  // commit into the deltas, narrowing on store
          for (int r = 0; r < R; ++r) {
            UsedT* u = used + r * used_stride + s;
            *u = (UsedT)(*u + (UsedT)req_sh[r]);
          }
          dcount[s] = (CountT)(dcount[s] + 1);
          for (int a = 0; a < A; ++a) {
            AffT* d = daff + a * aff_stride + s;
            *d = (AffT)(*d | (AffT)aff_sh[a]);
          }
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

// every instance has the same parameter list
using StreamKernel = decltype(&stream_bf_kernel<float, int32_t, uint32_t>);

// kKernels[used][count][aff], by the dtype codes of ops/ffd_kernels.py:
// used int16/uint16/f32, count int8/int16/int32, aff uint8/uint16/uint32
#define B4_AFF(U, N)                                                    \
  {                                                                     \
    stream_bf_kernel<U, N, uint8_t>, stream_bf_kernel<U, N, uint16_t>,  \
        stream_bf_kernel<U, N, uint32_t>                                \
  }
#define B4_COUNT(U) \
  { B4_AFF(U, int8_t), B4_AFF(U, int16_t), B4_AFF(U, int32_t) }
const StreamKernel kKernels[kCodes][kCodes][kCodes] = {
    B4_COUNT(int16_t), B4_COUNT(uint16_t), B4_COUNT(float)};
#undef B4_COUNT
#undef B4_AFF

constexpr size_t kUsedSize[kCodes] = {2, 2, 4};
constexpr size_t kCountSize[kCodes] = {1, 2, 4};
constexpr size_t kAffSize[kCodes] = {1, 2, 4};

bool valid_codes(int u, int n, int a) {
  return u >= 0 && u < kCodes && n >= 0 && n < kCodes && a >= 0 && a < kCodes;
}

// The dynamic shared memory each instance is allowed, per device:
// cudaFuncSetAttribute runs only when a launch needs more than was set.
constexpr int kMaxDevices = 64;
std::mutex g_smem_mutex;
int g_smem_allowed[kCodes][kCodes][kCodes][kMaxDevices] = {};

cudaError_t allow_smem(int u, int n, int a, size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(g_smem_mutex);
  int* allowed = dev < kMaxDevices ? &g_smem_allowed[u][n][a][dev] : nullptr;
  if (allowed != nullptr && (int)smem <= *allowed) return cudaSuccess;
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kKernels[u][n][a]),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess && allowed != nullptr) *allowed = (int)smem;
  return err;
}

}  // namespace

extern "C" {

// Bytes of one lane's delta carry under the dtype codes, or -1 for a
// code out of range.
long long stream_bf_state_bytes(int R, int A, int S, int used_code,
                                int count_code, int aff_code) {
  if (!valid_codes(used_code, count_code, aff_code)) return -1;
  return (long long)lane_bytes(R, A, S, kUsedSize[used_code],
                               kCountSize[count_code], kAffSize[aff_code]);
}

// Largest dynamic shared memory a block of every instance may use on
// `device`, or -1 on error.
int stream_bf_max_dynamic_smem(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  int static_bytes = 0;
  for (int u = 0; u < kCodes; ++u)
    for (int n = 0; n < kCodes; ++n)
      for (int a = 0; a < kCodes; ++a) {
        cudaFuncAttributes attr;
        if (cudaFuncGetAttributes(
                &attr, reinterpret_cast<const void*>(kKernels[u][n][a])) !=
            cudaSuccess)
          return -1;
        if ((int)attr.sharedSizeBytes > static_bytes)
          static_bytes = (int)attr.sharedSizeBytes;
      }
  return optin - static_bytes;
}

// Launch B4 over C lanes with the carry planes in the dtypes of the
// codes. `workspace` is null to hold each lane's carry in shared memory,
// else a buffer of C * stream_bf_state_bytes(...) bytes in device memory.
int stream_bf_launch(const float* slot_req, const uint8_t* slot_valid,
                     const int32_t* slot_tol, const int32_t* slot_aff,
                     const uint8_t* cand_valid, const float* spot_free,
                     const int32_t* spot_count, const int32_t* spot_max_pods,
                     const int32_t* spot_taints, const uint8_t* spot_ok,
                     const int32_t* spot_aff, uint8_t* feasible,
                     int32_t* chosen, int32_t* workspace, int C, int K, int R,
                     int W, int A, int S, int used_code, int count_code,
                     int aff_code, void* stream) {
  if (C <= 0) return (int)cudaSuccess;
  if (R < 1 || R > kMaxWords || W < 0 || W > kMaxWords || A < 0 ||
      A > kMaxWords || S < 0 || K < 0 ||
      !valid_codes(used_code, count_code, aff_code))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      workspace != nullptr
          ? 0
          : (size_t)stream_bf_state_bytes(R, A, S, used_code, count_code,
                                          aff_code);
  cudaError_t err = allow_smem(used_code, count_code, aff_code, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&slot_req,    &slot_valid, &slot_tol,      &slot_aff,
                  &cand_valid,  &spot_free,  &spot_count,    &spot_max_pods,
                  &spot_taints, &spot_ok,    &spot_aff,      &feasible,
                  &chosen,      &workspace,  &K,             &R,
                  &W,           &A,          &S};
  err = cudaLaunchKernel(
      reinterpret_cast<const void*>(kKernels[used_code][count_code][aff_code]),
      dim3(C), dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();  // clears a launch error
  return (int)(err != cudaSuccess ? err : last);
}

const char* stream_bf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
