"""Device compute primitives: distance kernels, top-k, quantization.

Replacements for the reference's hand-written SIMD (reference
src/hnsw/distance.rs, src/btree/simd_scan.rs): instead of AVX2/NEON
8-wide loops with runtime dispatch, distances are matmuls and fused
elementwise ops that XLA compiles for the device.
"""

from turdb_tpu.ops.distance import (  # noqa: F401
    Metric,
    pairwise_distances,
    gathered_distances,
    prep_norms,
)
from turdb_tpu.ops.topk import topk_smallest, merge_topk  # noqa: F401
