// K1's walk at bf16 operands (selective_scan.cu holds the entry point, the
// fp32 walk and the design note), in its own source so that the two dtypes'
// instantiations compile in parallel.
#include "scan_walk_split.cuh"

template cudaError_t vmt::selective_scan_walk<vmt::bf16>(const vmt::ScanArgs&,
                                                         const vmt::SplitArgs&, int, int,
                                                         cudaStream_t);
