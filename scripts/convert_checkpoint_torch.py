"""Checkpoint conversion CLI of the PyTorch port: reference ``.pt`` state_dict
<-> the port's native parameter file.

The port's twin of scripts/convert_checkpoint.py. The port's native format
is a ``torch.save`` file of the model's state_dict
(``videomamba_tpu_torch.checkpoint.save_params``); the reference format is
a plain ``.pt`` state_dict of fp32 CPU tensors, which the JAX package and
the reference both read.

Usage:
    # reference .pt -> native (the model config rebuilds the shapes; the
    # pos-embed is re-gridded and the temporal one resampled from
    # --ckpt-num-frame to --num-frames)
    python scripts/convert_checkpoint_torch.py to-native ckpt.pt params.pt \
        --embed-dim 192 --depth 24 --num-frames 8 --ckpt-num-frame 8

    # native -> reference .pt (for handing weights back to reference users)
    python scripts/convert_checkpoint_torch.py to-torch params.pt ckpt.pt \
        --embed-dim 192 --depth 24 --num-frames 8

Both build the model on the CUDA card unless ``--device cpu``.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _build(args, device):
    from videomamba_tpu_torch.models import PretrainVideoMamba

    return PretrainVideoMamba(
        img_size=args.img_size,
        patch_size=args.patch_size,
        depth=args.depth,
        embed_dim=args.embed_dim,
        channels=args.channels,
        kernel_size=args.kernel_size,
        num_frames=args.num_frames,
        rms_norm=args.rms_norm,
        fused_add_norm=args.rms_norm,
        add_pool_norm=not args.no_pool_norm,
        device=device,
    )


def main(argv=None):
    """Convert; returns the model holding the converted weights."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("mode", choices=["to-native", "to-torch"])
    parser.add_argument("src")
    parser.add_argument("dst")
    parser.add_argument("--img-size", type=int, default=224)
    parser.add_argument("--patch-size", type=int, default=16)
    parser.add_argument("--depth", type=int, default=24)
    parser.add_argument("--embed-dim", type=int, default=192)
    parser.add_argument("--channels", type=int, default=3)
    parser.add_argument("--kernel-size", type=int, default=1)
    parser.add_argument("--num-frames", type=int, default=8)
    parser.add_argument("--ckpt-num-frame", type=int, default=None,
                        help="frames the torch checkpoint was trained with "
                             "(to-native; default: --num-frames)")
    parser.add_argument("--rms-norm", action="store_true", default=True)
    parser.add_argument("--no-pool-norm", action="store_true")
    parser.add_argument("--device", default=None,
                        help="cuda (default: the card; raises without one) or cpu")
    args = parser.parse_args(argv)

    from videomamba_tpu_torch import checkpoint as ckpt
    from videomamba_tpu_torch.runtime import resolve_device

    model = _build(args, resolve_device(args.device))
    if args.mode == "to-native":
        ckpt_num_frame = args.ckpt_num_frame or args.num_frames
        ckpt.load_checkpoint(args.src, model, ckpt_num_frame=ckpt_num_frame,
                             num_frames=args.num_frames)
        ckpt.save_params(args.dst, model)
        print(f"wrote native params: {args.dst}")
    else:
        ckpt.load_params(args.src, model)
        ckpt.save_torch_state_dict(args.dst, model)
        print(f"wrote torch state_dict: {args.dst}")
    return model


if __name__ == "__main__":
    main()
