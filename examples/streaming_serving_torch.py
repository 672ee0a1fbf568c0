"""Example: long-video streaming inference with the PyTorch port's runtime.

The port's twin of examples/streaming_serving.py: streams a synthetic
224x224 clip through a VideoMamba preset (Base by default) in bf16, 64-frame
chunks, carrying the per-layer state across chunks. Prints each chunk's
pooled-feature norm and host time, and the throughput.

Run:  python examples/streaming_serving_torch.py [--frames 256] [--chunk 64]
      (on the CPU: --device cpu --preset tiny --frames 16 --chunk 4 --fp32)

Each chunk is timed on the host with the card synchronised before and
after. The first chunk also builds the kernels and warms up, so the median
of the later chunks is printed beside the total.
"""

import argparse
import os
import statistics
import sys
import time
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    """Stream the clip; returns what it measured and the model, video and
    first chunk's patch tokens (for callers that check the features)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--preset", default="base",
                        choices=["tiny", "small", "middle", "base"])
    parser.add_argument("--frames", type=int, default=256)
    parser.add_argument("--chunk", type=int, default=64)
    parser.add_argument("--batch", type=int, default=1,
                        help="independent video streams per card")
    parser.add_argument("--fp32", action="store_true")
    parser.add_argument("--mamba2", action="store_true",
                        help="serve the Mamba-2 (SSD) mixer variant")
    parser.add_argument("--device", default=None,
                        help="cuda (default: the card; raises without one) or cpu")
    args = parser.parse_args(argv)

    import torch

    from videomamba_tpu_torch import StreamingSession
    from videomamba_tpu_torch.data import iter_video_chunks
    from videomamba_tpu_torch.models import presets
    from videomamba_tpu_torch.runtime import resolve_device
    from videomamba_tpu_torch.utils.precision import cast_module_for_compute

    device = resolve_device(args.device)
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    name = f"videomamba_{args.preset}" + ("_m2" if args.mamba2 else "")
    model = getattr(presets, name)(
        num_frames=args.chunk, pool_type="avg", device=device,
        generator=torch.Generator().manual_seed(0),
    ).eval()
    if dtype != torch.float32:
        cast_module_for_compute(model, dtype)
    print(f"model={args.preset}{'+ssd' if args.mamba2 else ''} "
          f"dtype={str(dtype).replace('torch.', '')} "
          f"chunk={args.chunk} frames={args.frames} streams={args.batch}")

    # Synthetic video stream (replace with your decoder's frames).
    video = torch.randn((args.batch, 3, args.frames, 224, 224),
                        generator=torch.Generator().manual_seed(0)).to(device, dtype)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    session = StreamingSession(model, batch_size=args.batch, dtype=torch.float32)
    n_frames, chunk_ms, pools, first_vis = 0, [], [], None
    sync()
    t0 = time.perf_counter()
    for i, (chunk, _) in enumerate(
        iter_video_chunks(video, args.chunk, model.patch_embed.tubelet_size)
    ):
        t_chunk = time.perf_counter()
        x_vis, x_pool = session.process(chunk)
        sync()
        chunk_ms.append((time.perf_counter() - t_chunk) * 1e3)
        if first_vis is None:
            first_vis = x_vis
        pools.append(x_pool.float())
        n_frames += chunk.shape[2] * args.batch
        print(f"chunk {i:3d}: frames {n_frames:6d}  "
              f"|pool|={float(torch.linalg.vector_norm(x_pool.float())):.4f}  "
              f"{chunk_ms[-1]:.3f} ms")
    dt = time.perf_counter() - t0
    print(f"\nprocessed {n_frames} frames in {dt:.2f}s "
          f"(includes the kernel build and warm-up) -> {n_frames / dt:.0f} frames/sec "
          f"({n_frames / dt / 30:.1f}x real-time @30fps)")
    median_ms = statistics.median(chunk_ms[1:]) if len(chunk_ms) > 1 else None
    fps = None
    if median_ms is not None:
        fps = args.chunk * args.batch / (median_ms / 1e3)
        print(f"chunks 2-{len(chunk_ms)}: median {median_ms:.3f} ms a chunk -> "
              f"{fps:.1f} frames/sec")
    return SimpleNamespace(model=model, video=video, first_vis=first_vis, pools=pools,
                           chunk_ms=chunk_ms, median_ms=median_ms, fps=fps)


if __name__ == "__main__":
    main()
