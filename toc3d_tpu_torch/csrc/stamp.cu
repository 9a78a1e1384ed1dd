// The stamp log: the device clock of runtime/timer.StageTimer.
//
// One thread reads the card's global nanosecond timer (%globaltimer), takes
// the log's next slot with an atomic on the device, and writes the span's
// word (2 * span id + 1 for an end, + 0 for a begin) and the time there. The
// count goes on past the capacity, so a full log tells the host how many
// stamps it dropped; nothing wraps. As the slot is taken on the device, a
// stamp captured into a CUDA graph is a node with frozen arguments that
// appends a fresh entry on every replay, and nothing is read by the host
// until the log is drained.
#include "common.cuh"

__global__ void stamp_kernel(long long* log, unsigned* count,
                             unsigned capacity, long long word) {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  const unsigned i = atomicAdd(count, 1u);
  if (i < capacity) {
    log[2 * static_cast<size_t>(i)] = word;
    log[2 * static_cast<size_t>(i) + 1] = static_cast<long long>(ns);
  }
}

// log: (capacity, 2) int64; count: one uint32, the stamps taken so far
TOC3D_EXPORT int toc3d_stamp(void* log, void* count, int capacity, int word,
                             void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(log), static_cast<unsigned*>(count),
      static_cast<unsigned>(capacity), word);
  return static_cast<int>(cudaGetLastError());
}
