"""Hand-written Hopper kernels, each beside its plain PyTorch version.

K1 ``scan.selective_scan`` and K5 ``scan.selective_scan_bwd``, K2
``fused_add_norm.fused_add_norm`` and K8 ``fused_add_norm.fused_add_norm_bwd``,
K3 ``mixer_fused.mixer_fused`` and K6 ``mixer_bwd.mixer_bwd``, K4
``block_fused.block_fused`` and K7 ``block_bwd.block_bwd``, K9
``decode_step.decode_stack`` and K10 ``causal_conv.causal_conv`` launch CUDA
built from ``csrc/`` at first use (``_build``); each counts its launches in
``<wrapper>.launches``, and each takes fp32 or bf16 as its docstring says.
"""
