// CUDA IPC for the fabric's cross-process device leg (ici/ipc_pull.py).
//
// The sender exports the caching-allocator allocation that holds a
// payload row: the handle names the WHOLE allocation, so the row's offset
// from the allocation's base rides beside it.  The receiver maps the
// handle once per (peer, allocation), reads the row through the mapping
// with the p2p_copy kernel, and unmaps it when the cache drops it or the
// socket closes.  No byte moves here: these calls only name and map
// memory.  Plain C interface, so nvcc takes seconds; every function
// returns the CUDA error code (0 = success).
#include <cuda.h>
#include <cuda_runtime.h>
#include <string.h>

extern "C" int ipc_export(const void* ptr, int device,
                          unsigned char* handle_out,
                          unsigned long long* offset_out,
                          unsigned long long* size_out) {
  // cuMemGetAddressRange needs a current context on THIS thread (a
  // handler thread may never have touched the runtime): bind the
  // device's primary context first
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaFree(0);
  if (e != cudaSuccess) return (int)e;
  CUdeviceptr base = 0;
  size_t size = 0;
  CUresult r = cuMemGetAddressRange(&base, &size, (CUdeviceptr)ptr);
  if (r != CUDA_SUCCESS) return 10000 + (int)r;   // a CUresult, offset
  cudaIpcMemHandle_t h;
  e = cudaIpcGetMemHandle(&h, (void*)base);
  if (e != cudaSuccess) return (int)e;
  memcpy(handle_out, &h, sizeof(h));
  *offset_out = (unsigned long long)((CUdeviceptr)ptr - base);
  *size_out = (unsigned long long)size;
  return 0;
}

extern "C" int ipc_open(const unsigned char* handle, int device,
                        void** base_out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(base_out, h,
                                   cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int ipc_close(void* base) {
  return (int)cudaIpcCloseMemHandle(base);
}

extern "C" int ipc_handle_size(void) {
  return (int)sizeof(cudaIpcMemHandle_t);
}
