"""Hand-written Hopper kernels, each beside its plain PyTorch version.

K1 ``scan.selective_scan``, K2 ``fused_add_norm.fused_add_norm`` and K3
``mixer_fused.mixer_fused`` launch CUDA built from ``csrc/`` at first use
(``_build``); each counts its launches in ``<wrapper>.launches``.
"""
