// The output tiles of the Gram product, shared by its kernels (gram_tf32.cu:
// fp32 as 3xTF32; gram_bf16.cu: bf16, in 2 x 2 groups of tiles): the
// reduced-task schedule of
// the paper's Alg 3 (Fig 2c) enumerates the upper-triangle tiles only, in
// the order of core/partition.py::symmetric_tasks; the full schedule every
// tile.

#pragma once

#include <math.h>
#include <stdint.h>

namespace repro_gram_tasks {

// The tile (bi, bj) of task t: symmetric -> the t-th pair (i <= j) of
// [(i, j) for j in range(nb) for i in range(j + 1)]; full -> j-major.
__device__ __forceinline__ void task_tile(int64_t t, int nb, bool symmetric,
                                          int& bi, int& bj) {
  if (symmetric) {
    int64_t j = static_cast<int64_t>((sqrt(8.0 * t + 1.0) - 1.0) * 0.5);
    while ((j + 1) * (j + 2) / 2 <= t) ++j;
    while (j * (j + 1) / 2 > t) --j;
    bj = static_cast<int>(j);
    bi = static_cast<int>(t - j * (j + 1) / 2);
  } else {
    bj = static_cast<int>(t / nb);
    bi = static_cast<int>(t % nb);
  }
}

// Tasks of an N x N product in tiles of edge bt.
inline int64_t task_count(long long N, int bt, bool symmetric) {
  const int64_t nb = (N + bt - 1) / bt;
  return symmetric ? nb * (nb + 1) / 2 : nb * nb;
}

}  // namespace repro_gram_tasks
