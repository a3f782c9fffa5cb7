// Host functions of the out-of-core tiers' host -> device pipeline
// (repro_torch/core/staging.py).  No kernel: the PCIe copy engine does the
// work.
//
//   repro_h2d_pitched   one asynchronous host -> device copy of `rows` rows
//                       of `width` bytes, `spitch` bytes apart in (pinned)
//                       host memory and `dpitch` bytes apart on the card
//   repro_host_register / repro_host_unregister
//                       page-lock a host range in place (and undo it)
//
// Why a pitched copy.  The block sweeps and gram read A through a TMA
// tensor map where A's rows are a whole number of 16 bytes apart; rows of
// another width go by the kernels' own copies (tf32x3_cpasync, wgmma_ld),
// which are slower (PERF.md section 7: a padded bf16 copy read by wgmma
// took 37.94 ms where wgmma_ld took 132.62 at 262144 x 8191).  The copy
// engine writes each host row into a device row padded to 16 bytes at no
// extra PCIe traffic: exactly `width * rows` bytes cross the link.
//
// Why the registration is here and not torch.cuda.cudart()'s.  A refused
// cudaHostRegister (cudaErrorHostMemoryAlreadyRegistered, 712, for a range
// the caller or another matrix already registered) leaves the error as the
// runtime's last error, and PyTorch's next CUDA call raises it.  This
// library has its own runtime (nvcc links it statically), and clears its
// last error before it returns; page-locking is the driver's, so PyTorch's
// copies see the pages as pinned all the same.
//
// C interface (bound with ctypes; pointers and the stream as void*).  Each
// returns the CUDA error code (0 on success) and allocates nothing.
#include <cuda_runtime.h>

extern "C" int repro_h2d_pitched(void* dst, long long dpitch,
                                 const void* src, long long spitch,
                                 long long width, long long rows,
                                 void* stream) {
  cudaGetLastError();  // report this call's error, not an older one
  if (rows <= 0 || width <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dpitch == width && spitch == width)   // one run of bytes
    e = cudaMemcpyAsync(dst, src, static_cast<size_t>(width * rows),
                        cudaMemcpyHostToDevice, s);
  else
    e = cudaMemcpy2DAsync(dst, static_cast<size_t>(dpitch), src,
                          static_cast<size_t>(spitch),
                          static_cast<size_t>(width),
                          static_cast<size_t>(rows),
                          cudaMemcpyHostToDevice, s);
  cudaGetLastError();
  return static_cast<int>(e);
}

extern "C" int repro_host_register(void* ptr, long long bytes) {
  cudaGetLastError();
  const cudaError_t e = cudaHostRegister(ptr, static_cast<size_t>(bytes),
                                         cudaHostRegisterPortable);
  cudaGetLastError();  // a refused registration leaves no error behind
  return static_cast<int>(e);
}

extern "C" int repro_host_unregister(void* ptr) {
  cudaGetLastError();
  const cudaError_t e = cudaHostUnregister(ptr);
  cudaGetLastError();
  return static_cast<int>(e);
}
