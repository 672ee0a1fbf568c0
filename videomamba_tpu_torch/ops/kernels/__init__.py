"""Hand-written Hopper kernels, each beside its plain PyTorch version.

K1 ``scan.selective_scan``, K2 ``fused_add_norm.fused_add_norm``, K3
``mixer_fused.mixer_fused`` and K4 ``block_fused.block_fused`` launch CUDA
built from ``csrc/`` at first use (``_build``); each counts its launches in
``<wrapper>.launches``. K1 and K3 take fp32; K2 and K4 fp32 or bf16.
"""
