// Latency of one dependent float add on the card, for kernel B5's chain
// bound (the float SUM fold adds a group's rows one after another).
//
// One thread adds x to an accumulator `iters` times, each add waiting for
// the one before; chip_smoke.py times two iteration counts with CUDA
// events and divides the difference by the extra adds. Built by
// chip_smoke.py beside the package's kernels:
//
//   nvcc -gencode=arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC \
//        -o libchain_probe.so scripts/torch_chain_probe.cu

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void add_chain(T* acc_io, const T* x, long long iters) {
  T acc = acc_io[0];
  const T v = x[0];
#pragma unroll 16
  for (long long i = 0; i < iters; ++i) acc = acc + v;
  acc_io[0] = acc;
}

}  // namespace

extern "C" int hs_add_chain(void* acc_io, const void* x, long long iters, int is_f64,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    add_chain<double><<<1, 1, 0, st>>>(static_cast<double*>(acc_io),
                                        static_cast<const double*>(x), iters);
  } else {
    add_chain<float><<<1, 1, 0, st>>>(static_cast<float*>(acc_io),
                                       static_cast<const float*>(x), iters);
  }
  return static_cast<int>(cudaGetLastError());
}
