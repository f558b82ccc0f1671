// The position update q_new = integrate(q, dq, dt) for Hopper (sm_90a):
// one launch a substep.
//
// Replaces no TPU kernel: the JAX package leaves
// dartenv_tpu/engine/world.integrate_positions to XLA, which fuses it.
// The port's plain version (dynamics/batched.integrate_positions) indexes
// the BALL and FREE joints' columns with numpy arrays, so on the card each
// call is about 160 small launches and 18 pageable copies, each followed by
// a stream synchronization; on DartHumanWalker that held the host for most
// of a control step.  This kernel takes the whole update, the exp-map
// columns included, in one launch with no host-side index and no copy.
//
// What bounds it on this card: nothing of the card's.  Per env it reads
// 2 n floats and writes n (0.36 MB at n 29, B 1024: 0.1 us at 3.35 TB/s)
// and does a few hundred operations per BALL / FREE joint; the launch
// itself is the cost.  Design: ONE THREAD PER ENV (integrate_body.h's
// ig_env), 128 threads a block; the joint table (q_start, is_free of each
// BALL / FREE joint) is a small device array built once per model and
// device by the wrapper (dynamics/hopper_integrate.py).  n, the table's
// size and dt are run-time arguments, so one build serves every model.
//
// Built with -fmad=false: products and sums round separately, like the
// plain version.  Its linear columns equal the plain version's to the bit;
// the exp-map columns may part from it by a few float32 ulps where the
// card's reductions sum the three terms in another order.

#include <cuda_runtime.h>

#include "integrate_body.h"

#define IG_THREADS 128

__global__ void integrate_kernel(const float* __restrict__ q,
                                 const float* __restrict__ dq,
                                 float* __restrict__ out,
                                 const int* __restrict__ jt, int G, int B,
                                 int n, float dt) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= B) return;
    const size_t off = (size_t)e * n;
    ig_env(q + off, dq + off, out + off, n, jt, G, dt);
}

// q, dq, out: (B, n) float32, contiguous, out not aliasing q or dq; jt: G
// int32 pairs on the same device.  Launch on `stream`; returns the
// cudaError_t of the launch (0 = ok).
extern "C" int integrate_launch(const float* q, const float* dq, float* out,
                                const int* jt, int G, int B, int n,
                                float dt, void* stream) {
    if (B == 0) return 0;
    const int grid = (B + IG_THREADS - 1) / IG_THREADS;
    integrate_kernel<<<grid, IG_THREADS, 0, (cudaStream_t)stream>>>(
        q, dq, out, jt, G, B, n, dt);
    return (int)cudaGetLastError();
}
