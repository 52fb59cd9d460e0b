// P1 and P2: the two measurement probes of the repository.
//
// P1 replaces the TPU kernel scripts/probe_pallas_floor.py::_copy_kernel
// (called by copy1 and copy64): o = x + 1 on one (8, 128) f32 tile per
// block, one block (copy1) or 64 (copy64). It measures the cost of a
// launch, not of the work: 4 KB in and out per block is nanoseconds of
// HBM time against microseconds of launch. One CTA of 1,024 threads per
// tile, one element per thread.
//
// P2 replaces scripts/measure_mfu.py::_fma_kernel (called by vpu_peak):
// every element of a (512, 1024) f32 tile runs `iters` trips of 8 steps
// x = x * 1.000000119f + 1e-7f, with no memory traffic in the loop. It
// measures the FP32 pipe's issue rate. Two forms from one template:
//   FUSED:   __fmaf_rn, one rounding per step, the 67 TFLOP/s FMA peak;
//   unfused: __fmul_rn then __fadd_rn, two instructions per step, the
//            one-instruction-per-operation rate that every bound of
//            chip_smoke.py assumes (-fmad=false).
// Each element is one dependent chain, and a chain step waits on the
// previous one (4 cycles of latency), so each thread runs kChains = 2
// independent chains, elements i and i + n/2, interleaved: with 2,048
// resident threads per SM, each of the 4 schedulers holds 16 warps and so
// 32 independent warp instructions, against about 4 cycles of latency.
// The (512, 1024) tile is 262,144 threads, 1,024 blocks of 256: one wave,
// at most 8 blocks on each of the 132 SMs.
//
// Each is bit-equal to its plain version in ops/probes.py (built with
// -fmad=false; the intrinsics round as the PyTorch ops do, and the fused
// form's plain version takes each step in float64, exact here, and rounds
// it once).
//
// Launchers: the package's one C signature (fluctus_tpu_torch/launch.py);
// each returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 8 * 128;    // one (8, 128) tile per P1 block
constexpr int kChains = 2;        // independent P2 chains per thread
constexpr int kP2Threads = 256;

__global__ void __launch_bounds__(kTile)
p1_kernel(const float* __restrict__ x, float* __restrict__ o) {
  const int i = blockIdx.x * kTile + threadIdx.x;
  o[i] = __fadd_rn(x[i], 1.0f);
}

template <bool FUSED>
__device__ __forceinline__ float p2_step(float x) {
  if (FUSED) return __fmaf_rn(x, 1.000000119f, 1e-7f);
  return __fadd_rn(__fmul_rn(x, 1.000000119f), 1e-7f);
}

template <bool FUSED>
__global__ void __launch_bounds__(kP2Threads)
p2_kernel(const float* __restrict__ x, float* __restrict__ o, int half,
          int iters) {
  const int i = blockIdx.x * kP2Threads + threadIdx.x;
  if (i >= half) return;
  float a = x[i];
  float b = x[i + half];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      a = p2_step<FUSED>(a);
      b = p2_step<FUSED>(b);
    }
  }
  o[i] = a;
  o[i + half] = b;
}

}  // namespace

// a: x, o (n_tiles * 1,024 floats each), n_tiles, stream; one block per
// (8, 128) tile.
extern "C" int p1_copy_plus_one(const long long* a, int n) {
  if (n != 4) return -1;
  const int n_tiles = (int)a[2];
  if (n_tiles <= 0) return 0;
  p1_kernel<<<n_tiles, kTile, 0, (cudaStream_t)a[3]>>>((const float*)a[0],
                                                       (float*)a[1]);
  return (int)cudaGetLastError();
}

// a: x, o (n floats each, n a multiple of kChains * kP2Threads), n, iters,
// fused, stream.
extern "C" int p2_fma_chain(const long long* a, int n_args) {
  if (n_args != 6) return -1;
  const int n = (int)a[2], iters = (int)a[3];
  if (n <= 0) return 0;
  const int half = n / kChains;
  const int blocks = (half + kP2Threads - 1) / kP2Threads;
  cudaStream_t s = (cudaStream_t)a[5];
  const float* x = (const float*)a[0];
  float* o = (float*)a[1];
  if (a[4]) {
    p2_kernel<true><<<blocks, kP2Threads, 0, s>>>(x, o, half, iters);
  } else {
    p2_kernel<false><<<blocks, kP2Threads, 0, s>>>(x, o, half, iters);
  }
  return (int)cudaGetLastError();
}
