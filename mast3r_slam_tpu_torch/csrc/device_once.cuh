// Once per device, between threads: a launcher's one-time setup
// (cudaFuncSetAttribute raising a kernel's dynamic shared-memory limit)
// applies to the calling thread's current device only, so it is done once
// for each device that launches, not once per process. Two threads that
// race on one device both make the call, which is idempotent; a device
// index past kMaxDevices repeats it on every launch.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

constexpr int kMaxDevices = 64;

struct PerDeviceOnce {
  std::atomic<bool> done[kMaxDevices];

  template <typename Fn>
  cudaError_t run(Fn&& setup) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kMaxDevices) return setup();
    if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
    err = setup();
    if (err == cudaSuccess) done[dev].store(true, std::memory_order_release);
    return err;
  }
};
