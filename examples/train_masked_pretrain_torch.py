"""Example: VideoMAE-style masked pretraining steps of the PyTorch port,
sharded over a device mesh.

The port's twin of examples/train_masked_pretrain.py: tube masking, the
optimizer factory with no weight decay on the exempt parameters, the
cosine-warmup schedule, and the train step over a dp / fsdp mesh (FSDP2).
One process runs a one-rank mesh; under torchrun the ranks split into dp x
fsdp as the JAX example splits its devices.

Run:  python examples/train_masked_pretrain_torch.py --steps 5
      (Base width on a card: --embed-dim 768 --depth 24 --img 224 --batch 4;
       on the CPU: --device cpu)
"""

import argparse
import os
import sys
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    """Run the steps; returns each step's loss and host seconds."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--frames", type=int, default=8)
    parser.add_argument("--img", type=int, default=32)
    parser.add_argument("--mask-ratio", type=float, default=0.75)
    parser.add_argument("--depth", type=int, default=4)
    parser.add_argument("--embed-dim", type=int, default=128)
    parser.add_argument("--device", default=None,
                        help="cuda (default: the card; raises without one) or cpu")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from videomamba_tpu_torch.data import TubeMaskingGenerator
    from videomamba_tpu_torch.models import PretrainVideoMamba
    from videomamba_tpu_torch.parallel import init_train_state, make_mesh, make_train_step
    from videomamba_tpu_torch.runtime import resolve_device
    from videomamba_tpu_torch.utils.basic_utils import MetricLogger, compute_n_params
    from videomamba_tpu_torch.utils.distributed import get_world_size, init_run_group
    from videomamba_tpu_torch.utils.optimizer import create_optimizer
    from videomamba_tpu_torch.utils.profiling import StepTimer
    from videomamba_tpu_torch.utils.scheduler import get_cosine_schedule_with_warmup

    device = resolve_device(args.device)
    close_group = init_run_group(device)
    try:
        model = PretrainVideoMamba(
            img_size=args.img, patch_size=16, depth=args.depth, embed_dim=args.embed_dim,
            channels=3, fused_add_norm=True, rms_norm=True, residual_in_fp32=True,
            kernel_size=1, num_frames=args.frames, add_pool_norm=False, device=device,
            generator=torch.Generator().manual_seed(0),
        )
        print(f"params: {compute_n_params(model)}")

        n_dev = get_world_size()
        fsdp = 2 if n_dev % 2 == 0 and n_dev > 1 else 1
        mesh = make_mesh({"dp": n_dev // fsdp, "fsdp": fsdp, "tp": 1},
                         device_type=device.type)
        print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
        data_devices = n_dev
        if args.batch % data_devices:
            args.batch = data_devices * max(1, args.batch // data_devices)
            print(f"batch rounded to {args.batch} (divisible by {data_devices} data shards)")

        opt_args = SimpleNamespace(opt="adamw", lr=1e-3, weight_decay=0.05, momentum=0.9)
        optimizer = create_optimizer(opt_args, model)
        init_train_state(model, optimizer, mesh=mesh)
        schedule = get_cosine_schedule_with_warmup(
            optimizer, num_warmup_steps=2, num_training_steps=args.steps)

        grid = (args.frames, args.img // 16, args.img // 16)
        mask_gen = TubeMaskingGenerator(grid, args.mask_ratio)
        # One fixed mask: equal visible counts in every step (the generator
        # guarantees them within a batch).
        mask = mask_gen(args.batch, rng=np.random.default_rng(0))
        n_visible = int((~mask[0]).sum())

        def loss_fn(batch, generator):
            x_vis = model(batch["video"], mask=batch["mask"], generator=generator)
            loss = (x_vis.float() - batch["target"].float()).square().mean()
            return loss, {"loss": loss.detach()}

        train_step = make_train_step(model, optimizer, loss_fn=loss_fn)
        logger = MetricLogger()
        timer = StepTimer()
        g = torch.Generator().manual_seed(0)
        losses, seconds = [], []
        for i in range(args.steps):
            video = torch.randn((args.batch, 3, args.frames, args.img, args.img), generator=g)
            # Targets for the visible tokens (e.g. teacher features or pixels).
            target = torch.randn((args.batch, n_visible, args.embed_dim), generator=g)
            timer.reset_clock()
            metrics = train_step({"video": video, "target": target, "mask": mask})
            dt = timer.tick(metrics)
            schedule.step()
            logger.update(loss=metrics["loss"], grad_norm=metrics["grad_norm"])
            losses.append(logger.loss.value)
            seconds.append(dt)
            print(f"step {i}: loss={logger.loss.value:.5f} "
                  f"grad_norm={logger.grad_norm.value:.4f} ({dt:.3f}s)")
        print("\n" + timer.summary())
        return SimpleNamespace(losses=losses, seconds=seconds, n_visible=n_visible)
    finally:
        close_group()


if __name__ == "__main__":
    main()
