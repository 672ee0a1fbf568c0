"""gemm_share_pct.train: the share of the traced training steps' kernel
time spent in library product kernels (cuBLAS: in_proj, out_proj, the patch
embedding and their gradients), never kernels the port's own C entries
launched."""


def read(ctx):
    if ctx.trace is None or ctx.window.kind != "train":
        return None
    total = ctx.trace.kernel_s()
    if total <= 0:
        return None
    return 100.0 * ctx.trace.blas_kernel_s() / total
