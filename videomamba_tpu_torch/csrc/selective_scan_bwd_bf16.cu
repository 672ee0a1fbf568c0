// K5's walk and sums at bf16 operands (selective_scan_bwd.cu holds the entry
// point, the fp32 walk and the design note), in its own source so that the
// two dtypes' instantiations compile in parallel.
#include "scan_walk_split_bwd.cuh"

template cudaError_t vmt::selective_scan_bwd_walk<vmt::bf16>(
    const vmt::ScanBwdArgs&, const vmt::SplitBwdArgs&, int, int, float*, float*, float*,
    vmt::bf16*, vmt::bf16*, cudaStream_t);
