// The host's wait for an event recorded on the card, plain C interface. Entry
// ygz_event_wait; caller frontend/framestep_graph.py::FrameStepGraph.wait,
// which loads this library with ctypes.PyDLL so that the call keeps Python's
// interpreter lock: between a frame's replay and its output no other Python
// thread (the mapping worker) takes the lock, and the tracking thread does
// not have to win it back after the wait. No kernel; there is no JAX
// counterpart (XLA's dispatch waits inside the runtime).
#include <cuda_runtime.h>

// cudaEventSynchronize on `event` (a cudaEvent_t); returns its error code.
extern "C" int ygz_event_wait(void* event) {
  return static_cast<int>(
      cudaEventSynchronize(static_cast<cudaEvent_t>(event)));
}
