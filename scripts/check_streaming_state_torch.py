"""Chunked-vs-full streaming parity check of the PyTorch port (CLI).

The port's twin of scripts/check_streaming_state.py: builds a bare
``videomamba_tpu_torch`` Mamba layer, runs a full sequence and the same
sequence split in two with the state carried across, asserts that they
agree at rtol / atol 1e-4, and checks that gradients through the streaming
path are finite and not all zero. Runs on the CUDA card by default
(``--fast-path``: the fused mixer kernel forward and its backward kernel),
or on the CPU with ``--device cpu`` (the kernels' plain versions).

Usage:
    python scripts/check_streaming_state_torch.py --seed 7 --deterministic \
        --batch-size 2 --seqlen 12 --split 5 --d-model 16 --device cpu
"""

import argparse
import os
import sys
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _build_arg_parser() -> argparse.ArgumentParser:
    from videomamba_tpu_torch.determinism import add_determinism_args

    parser = argparse.ArgumentParser(
        description="Validate the VideoMamba streaming state path (PyTorch port)."
    )
    add_determinism_args(parser)
    parser.add_argument("--batch-size", type=int, default=2)
    parser.add_argument("--seqlen", type=int, default=12)
    parser.add_argument("--split", type=int, default=5)
    parser.add_argument("--d-model", type=int, default=16)
    parser.add_argument(
        "--fast-path", action="store_true",
        help="Use the hand-written kernels (their plain versions on the CPU); "
             "default: the plain path.",
    )
    parser.add_argument("--device", default=None,
                        help="cuda (default: the card; raises without one) or cpu")
    return parser


def check_streaming(mixer, x, split: int) -> SimpleNamespace:
    """``mixer`` over the whole of ``x`` (B, L, d_model) and over its two
    parts split at ``split`` with the state carried; asserts that the two
    agree at rtol / atol 1e-4 and that the input gradient of the split
    outputs' sum is finite and not all zero. Returns both outputs, that
    gradient and the largest |full - split| element."""
    import torch

    with torch.no_grad():
        out_full = mixer(x)
        out1, state = mixer(x[:, :split], return_state=True)
        out2, _ = mixer(x[:, split:], state=state, return_state=True)
        out_chunked = torch.cat([out1, out2], dim=1)
    torch.testing.assert_close(out_chunked, out_full, rtol=1e-4, atol=1e-4)
    max_diff = float((out_chunked - out_full).abs().max())

    x_ = x.clone().requires_grad_(True)
    o1, st = mixer(x_[:, :split], return_state=True)
    o2, _ = mixer(x_[:, split:], state=st, return_state=True)
    (o1.sum() + o2.sum()).backward()
    grad = x_.grad
    if not bool(torch.isfinite(grad).all()) or float(grad.abs().sum()) == 0.0:
        raise RuntimeError("Missing gradients for streaming path.")
    return SimpleNamespace(out_full=out_full, out_chunked=out_chunked, grad=grad,
                           max_diff=max_diff)


def main(argv=None) -> float:
    """Run the check; returns the largest |full - split| element."""
    args = _build_arg_parser().parse_args(argv)

    import torch

    from videomamba_tpu_torch.determinism import configure_determinism_from_args
    from videomamba_tpu_torch.models.mamba import Mamba
    from videomamba_tpu_torch.runtime import resolve_device
    from videomamba_tpu_torch.streaming import STREAMING_CONTRACT_VERSION

    device = resolve_device(args.device)
    configure_determinism_from_args(args)

    batch_size, seqlen, split = args.batch_size, args.seqlen, args.split
    if split <= 0 or split >= seqlen:
        raise ValueError("--split must be in range [1, seqlen-1].")

    g = torch.Generator().manual_seed(args.seed)
    mixer = Mamba(
        d_model=args.d_model, d_state=8, d_conv=4, expand=2,
        use_fast_path=bool(args.fast_path), device=device, generator=g,
    )
    x = torch.randn((batch_size, seqlen, args.d_model), generator=g).to(device)

    max_diff = check_streaming(mixer, x, split).max_diff
    print(f"full vs split at {split} of {seqlen}: max |diff| {max_diff:.3e}")
    print(f"Streaming state check passed. contract={STREAMING_CONTRACT_VERSION}")
    return max_diff


if __name__ == "__main__":
    main()
