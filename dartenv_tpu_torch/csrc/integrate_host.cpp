// Host build of the position-update kernel's per-env arithmetic
// (integrate_body.h's ig_env), as a plain loop over envs.  Build with a C++
// compiler and -ffp-contract=off (no a*b+c contraction, like the kernel's
// -fmad=false).  For tests on machines without a GPU; nothing on the main
// path calls it.
#include <stddef.h>

#include "integrate_body.h"

// Same arguments as integrate.cu's integrate_launch (no stream).
extern "C" int integrate_host(const float* q, const float* dq, float* out,
                              const int* jt, int G, int B, int n,
                              float dt) {
    for (int e = 0; e < B; ++e) {
        const size_t off = (size_t)e * n;
        ig_env(q + off, dq + off, out + off, n, jt, G, dt);
    }
    return 0;
}
