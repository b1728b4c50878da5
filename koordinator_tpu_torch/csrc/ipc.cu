// The exchange's mailboxes across processes (ops/kernel_common.py
// CudaIpc, used by Mailboxes on a mesh whose cards several processes hold).
//
// Replaces no TPU kernel: the JAX package's mesh spans processes through
// jax.distributed, and its node-sharded round merges winners with XLA
// collectives. The port's rounds exchange each pod's stats and winner
// through mailboxes that every shard's kernel reaches with plain stores
// (csrc/kernel_common.cuh, "The exchange"); a process reaches another
// process's mailbox only through CUDA IPC. So each process allocates its
// own shards' mailboxes here with cudaMalloc (an IPC handle names the
// base of an allocation, and a tensor of PyTorch's caching allocator may
// sit at an offset inside one), exports their handles, and maps every
// other process's with cudaIpcOpenMemHandle. Nothing here runs on the
// card but the zeroing: no bound applies.
//
// Every entry point acts on the current device and returns a cudaError_t
// (0 = done).

#include <cuda_runtime.h>
#include <string.h>

extern "C" {

// Bytes of one exported handle (cudaIpcMemHandle_t).
int koord_ipc_handle_bytes() { return (int)sizeof(cudaIpcMemHandle_t); }

// `bytes` of device memory at *ptr, zeroed, the zeroing finished.
int koord_ipc_alloc(long long bytes, void** ptr) {
  cudaError_t err = cudaMalloc(ptr, (size_t)bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemset(*ptr, 0, (size_t)bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceSynchronize();
}

int koord_ipc_free(void* ptr) { return (int)cudaFree(ptr); }

// The handle of the allocation at `ptr` into `out`
// (koord_ipc_handle_bytes() bytes).
int koord_ipc_export(void* ptr, unsigned char* out) {
  cudaIpcMemHandle_t h;
  const cudaError_t err = cudaIpcGetMemHandle(&h, ptr);
  if (err != cudaSuccess) return (int)err;
  memcpy(out, &h, sizeof(h));
  return 0;
}

// Another process's allocation, named by `handle`, mapped at *ptr for the
// current device (peer access turned on where it lies on another card).
int koord_ipc_open(const unsigned char* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

int koord_ipc_close(void* ptr) { return (int)cudaIpcCloseMemHandle(ptr); }

// `bytes` at `ptr` zeroed, the zeroing finished (after everything queued
// before it on the device).
int koord_ipc_zero(void* ptr, long long bytes) {
  const cudaError_t err = cudaMemset(ptr, 0, (size_t)bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceSynchronize();
}

// The PCI bus id of `device` ("0000:18:00.0"), into `out` of `len` bytes.
int koord_pci_bus_id(int device, char* out, int len) {
  return (int)cudaDeviceGetPCIBusId(out, len, device);
}

}  // extern "C"
