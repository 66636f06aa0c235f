// Page-locking of host memory that a caller already owns, so that the copy
// engines read it in place (runtime/host_register.py: a source's recurring
// blocks go to the card with no copy into a pinned slot).

#include <cstdint>

#include <cuda_runtime.h>

extern "C" {

// Page-lock [p, p + nbytes) for every CUDA context; 0 or a cudaError_t. A
// refusal (memory already registered, a read-only mapping) is taken off the
// runtime's last error, so that no later launch check reports it.
int pafb2p_host_register(void* p, int64_t nbytes) {
  const cudaError_t e = cudaHostRegister(p, static_cast<size_t>(nbytes),
                                         cudaHostRegisterPortable);
  if (e != cudaSuccess) cudaGetLastError();
  return static_cast<int>(e);
}

// Undo pafb2p_host_register(p, ...); 0 or a cudaError_t, cleared likewise.
int pafb2p_host_unregister(void* p) {
  const cudaError_t e = cudaHostUnregister(p);
  if (e != cudaSuccess) cudaGetLastError();
  return static_cast<int>(e);
}

}  // extern "C"
