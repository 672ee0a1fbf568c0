"""End-to-end supervised video classification on the PyTorch port.

The port's twin of examples/train_classifier.py: clip shards on disk ->
the native prefetch loader -> the train step over a dp / fsdp mesh (FSDP2)
-> a checkpoint each epoch -> evaluation each epoch. One process runs a
one-rank mesh; under torchrun the ranks split into dp x fsdp.

Run:  python examples/train_classifier_torch.py --epochs 2
      (on the CPU: --device cpu --depth 1 --embed-dim 32 --img 32 --frames 4)

Resume is exercised in the same process: the script saves the train state
after each epoch, then reloads the one before the last, replays the last
epoch and prints the largest parameter difference from the straight run.
"""

import argparse
import os
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def synthesize_dataset(root, n_classes=3, per_class=6, T=10, hw=48, seed=0):
    """Per-class motion patterns encoded as MJPEG (or raw) shards."""
    from videomamba_tpu_torch.data import native as nat

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw, 0:hw]
    paths, labels = [], []
    for c in range(n_classes):
        for i in range(per_class):
            phase = rng.uniform(0, 2 * np.pi)
            frames = []
            for t in range(T):
                # class controls the motion direction/frequency
                arg = (xx * (c + 1) / 10 + t * (c + 1) / 2 + phase
                       if c % 2 == 0 else
                       yy * (c + 1) / 10 - t * (c + 1) / 2 + phase)
                img = np.stack([
                    np.sin(arg) * 100 + 128,
                    np.cos(arg / 2) * 90 + 120,
                    ((xx + yy) * (c + 1) / 2 + t * 4) % 256,
                ], -1)
                frames.append(img)
            vid = np.stack(frames).clip(0, 255).astype(np.uint8)
            vid = (vid.astype(np.int16)
                   + rng.integers(-5, 6, vid.shape)).clip(0, 255)
            p = os.path.join(root, f"c{c}_{i}.vmjpg")
            try:
                nat.encode_vmjpg(p, vid.astype(np.uint8), quality=92, subsampling=0)
            except ImportError:  # no PIL: store raw
                p = os.path.join(root, f"c{c}_{i}.vraw")
                nat.write_vraw(p, vid.astype(np.uint8))
            paths.append(p)
            labels.append(c)
    return paths, labels


def _dataset(args):
    """(paths, labels, the synthesized shards' directory or None) from
    --file-list, --data-dir or synthesized shards; may set args.classes."""
    from videomamba_tpu_torch.data.dataset import load_file_list, scan_class_directories

    if args.file_list:
        paths, labels = load_file_list(args.file_list)
        args.classes = max(labels) + 1
        print(f"file list: {len(paths)} samples, {args.classes} classes")
        return paths, labels, None
    if args.data_dir:
        has_subdirs = any(
            e.is_dir() for e in os.scandir(args.data_dir) if not e.name.startswith("."))
        if has_subdirs:
            paths, labels, class_names = scan_class_directories(args.data_dir)
            args.classes = len(class_names)
            print(f"class dirs: {len(paths)} samples, "
                  f"{args.classes} classes {class_names[:8]}")
            return paths, labels, None
        # Flat layout: shards named c<label>_*.ext.
        paths = sorted(
            os.path.join(args.data_dir, f) for f in os.listdir(args.data_dir)
            if f.split(".")[-1] in {"vmjpg", "vraw", "npy"})
        return paths, [int(os.path.basename(p).split("_")[0][1:]) for p in paths], None
    root = tempfile.mkdtemp(prefix="vm_clf_")
    paths, labels = synthesize_dataset(root, n_classes=args.classes, hw=args.img)
    print(f"synthesized {len(paths)} videos in {root}")
    return paths, labels, root


def main(argv=None):
    """Train, evaluate and prove resume parity; returns the last step's
    loss (``.loss``, what the JAX example returns), the eval accuracies,
    the resume difference and the loader's clips/s."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--frames", type=int, default=8)
    parser.add_argument("--img", type=int, default=48)
    parser.add_argument("--classes", type=int, default=3)
    parser.add_argument("--depth", type=int, default=2)
    parser.add_argument("--embed-dim", type=int, default=64)
    parser.add_argument("--lr", type=float, default=3e-3)
    parser.add_argument("--data-dir", default=None,
                        help="dataset root: either class subdirectories "
                             "(root/<class>/<clip>.{vmjpg,vraw,npy}) or a "
                             "flat directory of shards named c<label>_*.ext "
                             "(synthesized when omitted)")
    parser.add_argument("--file-list", default=None,
                        help="Kinetics-style annotation file: one "
                             "'<path> <label>' per line")
    parser.add_argument("--ckpt-dir", default=None)
    parser.add_argument("--device", default=None,
                        help="cuda (default: the card; raises without one) or cpu")
    args = parser.parse_args(argv)

    import torch
    import torch.nn.functional as F
    from torch import nn

    from videomamba_tpu_torch.checkpoint import load_train_state, save_train_state
    from videomamba_tpu_torch.data.native import NativeClipLoader
    from videomamba_tpu_torch.models import PretrainVideoMamba
    from videomamba_tpu_torch.parallel import (
        full_state_dict,
        init_train_state,
        make_mesh,
        make_train_step,
    )
    from videomamba_tpu_torch.runtime import resolve_device
    from videomamba_tpu_torch.utils.distributed import get_world_size, init_run_group

    device = resolve_device(args.device)
    paths, labels, synth_dir = _dataset(args)

    class Classifier(nn.Module):
        """The backbone's ``cls+avg`` pooled features through a linear head."""

        def __init__(self):
            super().__init__()
            self.backbone = PretrainVideoMamba(
                img_size=args.img, patch_size=16, depth=args.depth,
                embed_dim=args.embed_dim, channels=3, fused_add_norm=True,
                rms_norm=True, residual_in_fp32=True, kernel_size=1,
                num_frames=args.frames, pool_type="cls+avg", add_pool_norm=True,
                device=device, generator=torch.Generator().manual_seed(0))
            self.head = nn.Linear(args.embed_dim, args.classes, device=device)
            with torch.no_grad():
                self.head.weight.copy_(0.02 * torch.randn(
                    (args.classes, args.embed_dim), generator=torch.Generator().manual_seed(1)))
                self.head.bias.zero_()

        def forward(self, video, generator=None):
            out = self.backbone(video, generator=generator)
            pooled = out[-1] if isinstance(out, tuple) else out
            if pooled.ndim == 3:  # pooled features carry a singleton token dim
                pooled = pooled[:, 0]
            return self.head(pooled.float())

    close_group = init_run_group(device)
    loaders = []
    try:
        model = Classifier()
        n_dev = get_world_size()
        fsdp = 2 if n_dev % 2 == 0 and n_dev > 1 else 1
        mesh = make_mesh({"dp": n_dev // fsdp, "fsdp": fsdp, "tp": 1},
                         device_type=device.type)
        print(f"ranks: {n_dev}, mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
        if args.batch % n_dev:
            args.batch = n_dev * max(1, args.batch // n_dev)
            print(f"batch rounded to {args.batch} (divisible by {n_dev} data shards)")
        loader = NativeClipLoader(paths, labels, clip_len=args.frames, crop=args.img,
                                  batch_size=args.batch, num_threads=4, train=True)
        eval_loader = NativeClipLoader(paths, labels, clip_len=args.frames, crop=args.img,
                                       batch_size=args.batch, num_threads=4, train=False)
        loaders = [loader, eval_loader]

        t0, clips = time.perf_counter(), 0
        for batch_clips, _ in loader.epoch(seed=0, shuffle=True, epoch=1000):
            clips += batch_clips.shape[0]
        clips_per_s = clips / (time.perf_counter() - t0)
        print(f"loader: {clips} clips in an epoch, {clips_per_s:.1f} clips/s")

        optimizer = torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=0.05)
        init_train_state(model, optimizer, mesh=mesh)

        def loss_fn(batch, generator):
            logits = model(batch["video"], generator=generator)
            loss = F.cross_entropy(logits, batch["label"])
            acc = (logits.argmax(-1) == batch["label"]).float().mean()
            return loss, {"loss": loss.detach(), "acc": acc}

        train_step = make_train_step(model, optimizer, loss_fn=loss_fn)

        def train_epoch(epoch):
            metrics = None
            for clips_, lbl in loader.epoch(seed=epoch, shuffle=True, drop_last=True,
                                            epoch=epoch):
                metrics = train_step({"video": clips_, "label": lbl})
            return metrics

        @torch.no_grad()
        def evaluate():
            model.eval()
            hits = total = 0
            for clips_, lbl in eval_loader.epoch(seed=0, shuffle=False):
                pred = model(clips_.to(device)).argmax(-1).cpu()
                hits += int((pred == lbl).sum())
                total += lbl.shape[0]
            return hits / max(total, 1)

        ckpt_dir = args.ckpt_dir or synth_dir or tempfile.mkdtemp(prefix="vm_clf_ckpt_")
        os.makedirs(ckpt_dir, exist_ok=True)
        ckpts, accs, step = [], [], 0
        for epoch in range(args.epochs):
            metrics = train_epoch(epoch)
            step += len(paths) // args.batch
            acc = evaluate()
            accs.append(acc)
            print(f"epoch {epoch}: loss={float(metrics['loss']):.4f} "
                  f"train_acc={float(metrics['acc']):.2f} eval_acc={acc:.2f}")
            ckpt = os.path.join(ckpt_dir, f"ckpt_ep{epoch}.pt")
            save_train_state(ckpt, model, optimizer, step)
            ckpts.append(ckpt)

        # --- prove checkpoint/resume parity ----------------------------
        diff = None
        if len(ckpts) >= 2:
            straight = full_state_dict(model)
            load_train_state(ckpts[-2], model, optimizer)
            train_epoch(args.epochs - 1)
            resumed = full_state_dict(model)
            diff = max(float((resumed[k].float() - v.float()).abs().max())
                       for k, v in straight.items())
            print(f"resume parity: max |param diff| after replayed epoch = {diff:.2e}")
        return SimpleNamespace(loss=float(metrics["loss"]), eval_acc=accs, resume_diff=diff,
                               clips_per_s=clips_per_s, ckpts=ckpts)
    finally:
        for ld in loaders:
            ld.close()
        close_group()


if __name__ == "__main__":
    main()
