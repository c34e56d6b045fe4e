// The frame trace's device stamp (utils/profiling.py, FrameTrace): one
// thread reads the card's %globaltimer (nanoseconds) and writes it into the
// trace's ring. It replaces no TPU kernel: the JAX package's frame is one
// XLA program whose per-pass times only a profiler sees, while the port's
// frame is a replayed CUDA graph, inside which no profiler range exists, so
// the graph carries its own stamps at its pass boundaries.
//
// The ring is (capacity, cols, 2) int64, one row per frame: a stamp goes to
// row frame % capacity as (frame, time) in each of its columns (up to four:
// a boundary between two spans is one stamp, the end of the one and the
// begin of the next), the frame read from a () int64 on the card that the
// host fills before each frame, so a graph captured once writes every
// replay's stamps into that replay's row and each cell names the frame
// that wrote it.
//
// Bound: 16 bytes written per column, nothing read but the frame; the
// launch (about a microsecond inside a graph) is the whole cost, which is
// why it is one thread, why a boundary takes one stamp and why the frame
// trace is off unless asked for.

#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(long long* __restrict__ ring, const long long* __restrict__ frame,
                             int capacity, int cols, int4 col) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long f = *frame;
  long long* row = ring + (f % capacity) * cols * 2;
  const int c[4] = {col.x, col.y, col.z, col.w};
  for (int i = 0; i < 4; ++i) {
    if (c[i] >= 0) {
      row[c[i] * 2] = f;
      row[c[i] * 2 + 1] = (long long)now;
    }
  }
}

}  // namespace

// Launches on `stream`; columns c1..c3 may be -1 (none). Returns
// cudaGetLastError() (0 on success).
extern "C" int rtt_stamp(long long* ring, const long long* frame, int capacity, int cols, int c0,
                         int c1, int c2, int c3, void* stream) {
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(ring, frame, capacity, cols,
                                                   make_int4(c0, c1, c2, c3));
  return (int)cudaGetLastError();
}
