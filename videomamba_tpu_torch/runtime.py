"""Streaming serving runtime: a stateful session over the chunk forward.

Port of ``StreamingSession`` from videomamba_tpu/runtime.py: per-layer
(conv_state, ssm_state) and the temporal offset are carried across chunk
calls; each batch row is an independent video stream. The decode session is
not ported yet. :func:`resolve_device` is the port's one rule for a device
that the caller did not name.
"""

from __future__ import annotations

from typing import List, Optional

import torch


def resolve_device(device=None) -> torch.device:
    """The device to build on: ``device`` when given, else the CUDA card.

    The port runs on the card unless the caller asks for the CPU; without a
    card, ``device=None`` raises instead of building on the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is available; pass device=\"cpu\" to build on the CPU"
        )
    return torch.device("cuda")


class StreamingSession:
    """Carries per-layer (conv_state, ssm_state) across chunk calls.

    Example:
        session = StreamingSession(model, batch_size=4)
        for chunk in video_chunks:         # (B, C, Tc, H, W) each
            x_vis, x_pool = session.process(chunk)

    CLS appears in chunk 0 only, so pooled outputs need ``pool_type='avg'``
    from chunk 1 on. Reset rows with :meth:`reset` when their streams end.
    States are fp32 unless ``dtype`` says otherwise, at a bf16 model too.
    """

    def __init__(
        self,
        model,
        batch_size: int,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        self.model = model
        self.batch_size = batch_size
        self.state = model.allocate_state(batch_size, dtype=dtype, device=device)
        self.offset = 0  # temporal tokens (post-tubelet)

    @torch.no_grad()
    def process(self, chunk: torch.Tensor, mask=None, keep_temporal: bool = False):
        """Run one chunk; returns the model's forward outputs minus the state,
        which the session keeps."""
        out = self.model(
            chunk,
            mask=mask,
            keep_temporal=keep_temporal,
            ssm_state=self.state,
            temporal_pos_offset=self.offset,
        )
        *outputs, self.state = out
        self.offset += chunk.shape[2] // self.model.patch_embed.tubelet_size
        return tuple(outputs) if len(outputs) > 1 else outputs[0]

    def reset(self, rows: Optional[List[int]] = None) -> None:
        """Zero the carried state (all rows and the offset, or given rows).
        Zeroes in place: the session owns its state tensors."""
        if rows is None:
            conv, _ = self.state[0]
            self.state = self.model.allocate_state(
                self.batch_size, dtype=conv.dtype, device=conv.device
            )
            self.offset = 0
            return
        idx = torch.as_tensor(rows, dtype=torch.long)
        for conv, ssm in self.state:
            conv[idx.to(conv.device)] = 0
            ssm[idx.to(ssm.device)] = 0
