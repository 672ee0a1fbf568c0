"""Drive the PyTorch port's serving, training, decode, masked-pretraining, data and distribution paths, its scripts and examples on one CUDA card and check them.

    python3 chip_smoke.py

Needs a CUDA card and nvcc; it builds the hand-written kernels from
``videomamba_tpu_torch/csrc`` first. Phases, each of which raises on
failure, so the script exits nonzero:

1. kernels: K1 (selective scan), K2 (fused add + RMSNorm) and K3 (fused
   mixer) against their plain PyTorch versions on the card at
   VideoMamba-Base shapes (B=1, L=1569, E=768, Di=1536, N=16, R=48), fp32,
   rel_err <= 1e-5, two runs bit-identical; each timed beside its plain
   version; K1's and K3's launches' device time a call under torch.profiler
   (K3's conv and products, and the time-split walk's chunk states, pass and
   output walk).
2. forward: VideoMamba-Base fp32 (depth 24, pool 'avg', weights from a
   seeded torch.Generator), full clip (1, 3, 8, 224, 224), kernels on,
   against the plain path on the card (rel_err <= 1e-4: 24 layers of
   reordered fp32 sums); K2 runs 25 times and K3 24 times per forward.
3. stream: StreamingSession over two 4-frame chunks; stitched patch tokens
   against the full clip, rel_err <= 1e-4.
4. unfused: one Base-width Mamba layer with conv_bias=False (the mixer's
   unfused branch) runs K1, against the plain path, rel_err <= 1e-5.
5. kernels at bf16: K4 (whole Block) against its plain version at Base
   shapes in bf16 with nonzero h0 and conv_state (rel_err <= 1e-2) and at
   Small shapes in fp32, the fp32 whole-block route (<= 1e-5), two runs
   bit-identical, and each of K4's launches' device time a call; K2 with a
   bf16 x and an fp32 residual (<= 1e-2); each timed beside its plain version.
6. bf16 forward: the Base weights of phase 2 cast for bf16 serving
   (utils/precision.py), full clip, kernels on: 24 K4, 1 K2 and 0 K3
   launches per forward; against the same Blocks' plain versions on the
   captured input tokens, rel_err <= 2e-2 (one-ulp bf16 flips carried
   through 24 layers); the max and mean relative error against phase 2's
   fp32 features are printed.
7. bf16 stream: StreamingSession over two 4-frame chunks; stitched patch
   tokens against the bf16 full clip, rel_err <= 1e-2; states stay fp32.
   Then the fp32 and bf16 Base serving times (full clip, first and
   continuation chunk) and, under torch.profiler, the full clip's and first
   chunk's device kernel time, idle share and top kernels.

8. backward kernels at Base shapes (B=1, L=1569, nonzero h0, conv_state
   and h_last cotangent): K1's and K3's checkpoints (fp32, 1e-5) and K1 with
   bf16 operands (1e-2); K3 at bf16 (1e-2); K5 (selective-scan backward,
   with and without D, z and delta_bias), K6 (mixer backward, all 11
   gradients) and K8 (add-norm backward) against
   their plain versions, fp32 within 2e-5 (K8 1e-5) and bf16 within 2e-2
   (K8 bf16 x with an fp32 residual, 1e-2); K6 also at B=4 (the split
   reverse walk at its other chunk; L 1569 is no multiple of either); K8
   also at B=4 (fp32, 1e-5) and with a bf16 x beside an fp32 g_out
   (dweight and dbias 1e-5: the cotangent read at its own dtype); K1,
   K5, K6 and K8 run twice on the same inputs and must be bit-identical;
   each timed beside its plain version; each of K5's and K6's launches'
   device time a call (the split reverse walk's chunk cotangents, pass and
   output walk, the partial sums, K6's product tiles and conv backward) and
   K8's (its row pass and its column sum, and their share of K8's byte
   bound) and K2's under torch.profiler. K1 (with checkpoints) and K5 at
   B=4, fp32 and bf16, twice bit-identical, each launch's device time a
   call.
9. fp32 train step, Base depth 24, B=2, clip (2,3,8,224,224) and a noise
   target (a zero target leaves only cancellation noise below the final
   RMSNorm to compare), one step of ``make_train_step``'s default loss
   (AdamW): loss within 1e-5 and every gradient within 1e-4 of the plain
   path on the card (24 layers of reordered fp32 sums); launches K2 25,
   K3 24, K6 24, K5 0, K8 0, K4 0.
   The same step under VIDEOMAMBA_MIXER_BWD=composite and
   VIDEOMAMBA_NORM_BWD=pallas: K5 24, K8 25 launches, gradients within 1e-4
   of the default route. checkpoint_num=24 with drop_path_rate=0.1 and a
   fixed generator: the gradients of the unchecked model within 1e-6.
10. bf16 mixed-precision train step, the bench.py recipe (AdamW lr 1e-4,
    weight decay 0.05, compute_dtype bf16): one step at B=2 on phase 9's
    batch against the same model with every kernel wrapper swapped for its
    plain version (the kernels' rounding points, no kernel): loss within 1e-2,
    every gradient within 5e-2 max rel (mean rel printed); max and mean rel
    against phase 9's fp32 gradients printed. Then steps at B=4 on the
    recipe's zero target: finite loss each step, fp32 masters.
11. times: fp32 and bf16 train step at B=4 (host ms, medians of 5 steps
    after 2 warm ones) and the peak device memory of each.
12. K4's checkpoints (fp32 1e-5, bf16 1e-2) and K7 (whole-Block backward)
    against their plain versions with nonzero h0, conv_state and every
    cotangent: Base
    bf16 (2e-2) and fp32 (2e-5), Small fp32 (2e-5), Base bf16 at B=4; K7
    twice bit-identical, each of its launches' device time a call;
    K10 (causal conv) at (1, 1569, 1536) and (4, 1569, 1536), W = 4, fp32
    (1e-5) and bf16 (1e-2), twice bit-identical; each timed beside its
    plain version, its device time a call and its share of the byte bound.
13. eval-mode backward: the bf16 Base model in eval(), a loss on x_vis and
    x_pool against noise targets: every parameter gets a gradient, K4 24
    and K7 24 launches, gradients within 5e-2 of the same model on plain
    versions; under VIDEOMAMBA_BLOCK_BWD=composite (which, as in the JAX
    package, selects the backward of differentiated whole-block calls;
    training under it stays on the mixer route) K1 24 and K5 24 in the
    recompute, K7 0, within 5e-2 of the K7 gradients.
14. the opt-in whole-block training route (VIDEOMAMBA_BLOCK_BWD=fused): the
    bf16 recipe step at B=2, K4 24, K7 24, K3 0, K6 0 launches, loss within
    1e-2 and gradients within 5e-2 of the same model on plain versions;
    then its B=4 step time and peak memory beside phase 11's mixer route.
15. decode at Base, fp32 and bf16: StreamingSession prefill of 4 frames,
    DecodeSession.load_streaming_state, the 5th frame's 196 tokens through
    K9 (+ K2, the final norm; 196 launches of each) against the 5-frame
    full forward's last 196 tokens (fp32 1e-4, bf16 2e-2); K9 against its
    plain version from the same states over 8 steps (fp32 1e-5, bf16
    1e-2), and at B=8, 9, 80 and 81 (the edges of its batch tiles of 8 and
    16) over 3 steps, and at d_model 60 (not a multiple of 8: padded with
    zero lanes) over 3 steps at B=3, each first token run twice from the
    same states and bit-identical; K9's time per token at B=1, 8 and 80 (CUDA events over
    100 back-to-back tokens) with each phase's device time a token (in,
    x_proj, state, out, from the kernel's own global-timer stamps), the
    session
    step's host time, and the device's kernel time and idle share under
    torch.profiler.
16. K10's route, ``causal_conv1d(use_kernel=True)`` at (4, 1569, 1536),
    forward and backward against the plain composition (1e-5).
17. Mamba-2 kernels at VideoMamba-Base-m2 shapes (B=1, L=1569, E=768, 24
    heads of 64, d_state 64, chunk 128, nonzero h0 and conv window): K12
    (SSD mixer core) and K14 (projected mixer) against their plain versions,
    fp32 (1e-5) and bf16 (1e-2), K12 with two groups at Di 512, and both
    at upstream Mamba-2's chunk 256 and d_state 128 (fp32 and bf16); each
    timed beside its plain version. K14's launches at Base m2, fp32 and
    bf16, split in the order they run into in_proj, the span and out_proj
    (device ms under the profiler), and ``torch.matmul`` (TF32 off) at its
    two product shapes as their yardstick (event ms, TFLOP/s).
18. m2 fp32 serving: ``videomamba_base_m2`` with seeded weights, full clip:
    K2 25, K14 24, K12 0 launches, against the same weights on the plain
    add-norm and the plain chunked SSD (VIDEOMAMBA_SSD_METHOD=chunked),
    1e-4; StreamingSession over two 4-frame chunks against the full clip
    (1e-4); the forward under VIDEOMAMBA_SSD_PMIXER=0 (K12 24, K14 0)
    against the K14 forward (1e-4).
19. m2 bf16 serving: the phase-18 weights cast for bf16: K2 25, K14 24,
    against the same model with every kernel swapped for its plain version
    (2e-2), max and mean relative error against phase 18's fp32 features
    printed; two-chunk streaming (1e-2, fp32 states). Then the m2 full-clip
    and chunk host times at fp32 and bf16, printed beside the Mamba-1 ones;
    then, after every host timing of the family, the device time, idle share
    and top kernels of a full clip and a first chunk under torch.profiler
    (for both families).
20. m2 decode, fp32 and bf16: phase 15 with K15 (decode_stack_m2, one
    launch a token, three phases a layer) in K9's place: the 5th frame's 196
    tokens against the 5-frame forward (1e-4 / 2e-2), K15 against its plain
    version over 8 steps at B=1 and at B=8, 9, 80 and 81 and at d_model 100
    (B=3; bit-identical repeats), ms a token at B=1, 8 and 80 with each
    phase's device time (in, state, out), profiler idle.
21. Mamba-2 training kernels at Base-m2 shapes, B=1 and B=4, fp32 and
    bf16 (nonzero h0, conv window and h_last cotangent): K12 with its
    checkpoints (each chunk's entry state, the pre-gate y), K11 (the bare
    SSD scan) forward and backward, K13 (the mixer backward) and K14's
    backward against their plain versions, fp32 within 2e-5 and bf16
    within 2e-2, the backward kernels twice bit-identical, each timed
    beside its plain version; K13's launches at fp32 and bf16, B=1 and 4,
    summed into the parts of its span, and K14's backward's into its
    products, gate, K13's span and ordered sums (device ms under the
    profiler); then all five at head dim 256 and at d_state 256 (fp32).
    Before them, K14's backward product tile alone (``projection_product``:
    wgmma fed by TMA, fp32 as three TF32 products) at its three layouts
    and both dtypes, at B L = 1, 1569 and 6276 rows and at row strides TMA
    cannot describe (its staging variant), against a float64 product (fp32
    2e-5, bf16 2e-2), twice bit-identical.
22. m2 training, ``make_train_step`` on ``videomamba_base_m2`` with the
    bench recipe (AdamW lr 1e-4, weight decay 0.05): at fp32 and bf16
    compute over fp32 masters one B=2 step on the default ("mixer") train
    route, K2 25, K12 24, K13 24 launches, against the same model with every
    kernel wrapper taking its plain version (loss 1e-5 / 1e-2, gradients
    1e-4 / 5e-2); then 2 warm and 5 timed B=4 steps on the zero target
    (median host ms, peak memory). At fp32 one step each under
    VIDEOMAMBA_SSD_TRAIN_ROUTE=pmixer (K14 24, its backward 24) and
    VIDEOMAMBA_SSD_BWD=composite (K12 24, K11's backward 24), gradients
    within 1e-4 of the default route; at bf16 one pmixer-route step against
    the same step on plain versions (5e-2); checkpoint_num=24 with
    drop_path_rate=0.1 against no remat (1e-6).
23. K11's route, ``ssd_chunked(method="pallas")`` at Base-m2 shapes (B=2),
    forward and backward against ``method="chunked"`` (1e-4).
24. Mamba-1 kernels at the state sizes the JAX package's kernels take
    beyond 8/16/32/64, at Base widths: K1 and K5 at d_state 24, 128 and
    256 (two slices of 128), K3 and K6 (fp32), K4 and K7 (bf16) at 24 and
    128, each against its plain version.
25. shapes the JAX package's gates take that the port once refused or ran
    past its arrays: K13 at conv width 9 (Base-m2, fp32, 2e-5) and K6 at
    width 9 (Base, fp32, 2e-5), each twice bit-identical; K2 and K8 at
    D = 3200 (1e-5 / 2e-5; K8's launches' device time and share of its
    byte bound); the train step of a Mamba(768, d_conv=9) layer
    (K3 1, K6 1) and of a Mamba2(768, d_conv=9) layer (K12 1, K13 1) at
    B=1, L=1569 against the same layer on plain versions on the card
    (output 1e-5, parameter gradients 1e-4: each sums a kernel output over
    all rows); ``causal_conv1d(use_kernel=True)`` at width 5 (K10 1, 1e-5).
26. masked serving at Base, B=2, a VideoMAE tube mask (ratio 0.75 on 8 x 14
    x 14: 1 + 8 * 49 = 393 visible tokens, no multiple of any walk chunk):
    fp32 (K2 25, K3 24) against the plain path (1e-4), ``keep_temporal``
    pooling through the masked temporal average, the mask as a CUDA tensor
    bit-equal to the NumPy one; bf16 (K4 24, K2 1) against the same Blocks'
    plain versions (2e-2); ``videomamba_base_m2`` fp32 (K14 24) against the
    plain chunked SSD (1e-4); a masked two-chunk StreamingSession (CLS in
    chunk 0 only), each chunk against the same model's single-chunk forward
    from the same state and against the plain path's session (1e-4).
27. masked pretraining, ``make_train_step`` with the mask in the batch (the
    default loss regresses the 392 visible patch tokens onto a noise
    target), the bench recipe: fp32 B=2 (K2 25, K3 24, K6 24) against the
    plain path (loss 1e-5, gradients 1e-4), bf16 over fp32 masters against
    the same step on plain versions (loss 1e-2, gradients 5e-2); then the
    masked fp32 and bf16 steps at B=4 (median host ms of 5 after 2 warm,
    peak memory) printed beside phase 11's unmasked ones.
28. from files: 8 seeded clips (16 x 256 x 320, ``.npy`` and ``.vraw``)
    written under ``build/``, ``make_clip_loader`` (native loader, train
    augmentation, 8 frames, 224 crops, B=2) over two pinned epochs by two
    loaders: bit-equal batches; the loader's clips/s; one masked fp32 step
    on a loaded batch (finite loss, K6 24).
29. ``BiMambaRefinerBlock(768)`` (Base ssm config, RMSNorm, fused add-norm,
    fp32 residual) on phase 2's (1, 8, 196, 768) patch tokens: fp32 K2 2,
    K3 2 against its plain version (1e-4), the forward state after two
    4-frame calls against one 8-frame call (1e-4), bf16 K4 2 against its
    plain versions (2e-2).
A. sequence parallelism at Base width on one card, after a one-rank NCCL
   group is started through ``utils.distributed.init_distributed_mode``
   (torchrun's variables, a file rendezvous under ``build/``): one Base
   Mamba-1 Block (RMSNorm, fused add-norm, fp32 residual) over a 16-frame
   clip, B=1, L 3136, split into 4 time shards of 784 and run through the
   ranks' functions (``parallel.sequence.sequence_parallel_mixer_shards``:
   K2 4, K1 4 forward, K5 4 backward) against the same Block's single-card
   forward (K3) and backward (K6): output, returned (conv_state,
   ssm_state), parameter and input gradients within 1e-4; a Base-m2 mixer
   the same way through ``sequence_parallel_ssd(method="pallas")`` (K11 4
   forward, 4 backward) against the single-card ``Mamba2`` (K12, K13),
   1e-4; each path's forward + backward device ms; then the public
   ``sequence_parallel_mixer`` on the NCCL group (K1 1), bit-equal to the
   single-shard path.
B. tensor parallelism: a Base Mamba-1 mixer split over 2 ranks
   (``Mamba.keep_channels``; the gathered parameters bit-equal to the
   unsplit ones) through ``models.mamba.tensor_parallel_shards``
   (``channel_parallel``, the code a ``shard_channels`` mixer's forward
   runs, the parts of x_dbl and of the output summed where its all-reduces
   run; K1 2, K5 2), against the single-card mixer (K3, K6): output 1e-5,
   gradients 1e-4.
C. the sharded train step: phase 11's Base B=4 step under
   ``init_train_state(mesh=make_mesh({"dp": 1, "fsdp": 1, "tp": 1}))``
   (FSDP2 over the one-rank NCCL group): three fp32 steps on a noise target
   against the unsharded step from the same weights (loss and grad_norm
   1e-5 each step, the gathered parameters 1e-5; K2 25, K3 24, K6 24 a
   step), then the bench recipe's steps (median host ms of 5 after 2 warm,
   peak memory) beside phase 11's, each step once more under the profiler
   (host and device ms, top kernels) with the unsharded one; the same for
   bf16 (one step: loss 1e-2, gradients 5e-2); then the fp32 steps with a
   fused AdamW. The process group is destroyed after.
30. checkpoint files and determinism (it sets process-wide modes and
    restores them):
    ``save_torch_state_dict`` of phase 2's weights, ``load_checkpoint`` into
    a fresh Base model on the card, bit-equal parameters and phase 2's
    forward bit for bit; a seeded temporal embedding loaded with
    ``ckpt_num_frame=8`` into a 16-frame model (against ``F.interpolate``,
    1e-6) and a 16-frame clip through it; ``configure_determinism(0,
    deterministic=True)`` and the masked fp32 step twice: bit-identical
    loss and gradients; TF32 off and non-deterministic mode restored.
D. the ops surface: ``selective_scan_bld`` at Base shapes with "chunked",
   "pallas" and "kernel", each one K1 launch against "ref" (the sequential
   plain version, 1e-5); the reference-layout ``selective_scan`` bit-equal
   to it; a Base-width unfused ``Mamba`` (K1) with ``scan_chunk_size=32``
   bit-equal to the default one.
E. ``scripts/check_streaming_state_torch.py`` (``main``) at d_model 768, L
   3136 (16 frames of Base tokens) split at 1568, ``--fast-path`` (K3 5,
   K6 2) and ``--allow-tf32 off``: full against split at rtol / atol 1e-4,
   finite non-zero gradients through the split; its max |diff| printed.
F. ``scripts/convert_checkpoint_torch.py``: a seeded Base model written as
   a reference ``.pt``, ``to-native`` then ``to-torch`` bit-equal to it; the
   model the CLI loaded gives the source's features bit for bit (fp32,
   (1, 3, 8, 224, 224)); ``--num-frames 16 --ckpt-num-frame 8`` against
   ``load_checkpoint`` of the same file: parameters and a 16-frame forward
   bit-equal.
G. ``examples/streaming_serving_torch.py`` at the serving headline shape:
   Base, 64-frame chunks of a 256-frame clip (L 12,544 a chunk), bf16 (K4
   24, K2 1 a chunk), ``--mamba2`` (K14 24, K2 25) and ``--fp32`` (K2 25,
   K3 24); the first chunk's x_vis against a full forward of those 64
   frames (2e-2 bf16, 1e-4 fp32); the last layer on its kernels against
   its plain version on the same inputs at chunk 1 and at chunk 2, from the
   carried state (output, residual, conv window, SSM state; 1e-2 for K4
   and K14 at bf16, 1e-5 for K3); the bf16 stream's pooled features against
   the fp32 stream's (gated at 2e-2, printed beside BASELINE.md's 1e-3);
   each chunk's host ms and the median of chunks 2-4 with its frames/s.
H. ``examples/train_masked_pretrain_torch.py`` at Base width (depth 24, img
   224, 8 frames, B=4, 5 steps) on a world-1 mesh (FSDP2 over a one-rank
   NCCL group it starts and ends): finite losses falling from step 0 to
   step 4, K2 25, K3 24, K6 24 a step; each step's host ms and the peak.
I. ``examples/train_classifier_torch.py`` at Base width (depth 24, img 224,
   8 frames, B=4, 2 epochs, 3 classes) under ``configure_determinism(0,
   deterministic=True)``: synthesized shards, the native loader, FSDP2
   steps, the train state saved each epoch (shards gathered), the one
   before the last reloaded into the shards and the last epoch replayed:
   resume parity exactly 0; eval accuracy each epoch, the loader's clips/s.
J. ``utils.profiling``: ``trace`` around two Base fp32 forwards writes a
   Chrome trace whose CUDA kernels hold K2's row kernel 50 times and K3's
   output walk 48 times, as the counters; ``StepTimer``'s median within 10
   % of CUDA-event time; ``device_memory_summary`` equal to
   ``torch.cuda.memory_stats``' peak; ``MetricLogger.log_every`` prints a
   memory column.

The launch counters are zeroed just before each main path and read just
after: phases 2-4 (fp32 serving), 6-7 (bf16 serving), 9 (fp32 training),
10 (bf16 training), 13 (eval backward), 14 (whole-block training), 15
(decode, per dtype), 16 (the conv route), 18 (m2 fp32 serving, both
routes), 19 (m2 bf16 serving), 20 (m2 decode, per dtype), 22 (m2
training, every route), 23 (K11's route), 25 (the layer steps and the
conv route at widened gates), 26 (masked serving), 27 (masked training),
28 (the step from files), 29 (the refiner), A (the sequence-parallel Block,
m2 mixer and public mixer), B (the tensor-parallel mixer), C (the sharded
steps), 30 (the loaded models and the deterministic steps) and each of D-J;
the kernels line sums them. The single-card references of A-C run outside those
windows. The total seconds
of the run are printed before the kernels line.
TF32 is off for matmuls and cuDNN throughout. Times are CUDA-event times per
launch (kernels) or host time around a synchronised call (forward, chunk,
step, token), on the card named in the output. Each kernel's bound is
computed from the inputs it was timed on: the larger of the bytes it must
move over 3.35 TB/s and its operations over the peak rate of their type
(989 TFLOP/s bf16 tensor cores, 67 TFLOP/s fp32; K14's backward runs its
fp32 projection products as three TF32 products, so they count three times
at 495 TFLOP/s, and the FMA bound is printed beside). One PyTorch call computes
K10's function without its SiLU and with a zero window,
``F.conv1d(..., groups=D)`` on the channels-first layout, so phase 12 also
times K10 that way and the K10 row's ``library_ms`` is that call's time; no
single PyTorch call computes any other kernel's function, so their
``library_ms`` is null. The kernels line reports K7 at bf16 Base,
K9 at fp32 B=1 (one launch is one token through the stack: one persistent
CUDA launch of 4 x depth phases) and K10 at fp32 B=1. The last stdout line is the contract JSON;
the line before it lists the kernels (17 rows: K12 and K14 at fp32 Base
m2, K15 at fp32 B=1, K11's forward and backward, K13 and K14's backward
at fp32 Base m2, B=1).
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from videomamba_tpu_torch.checkpoint import (  # noqa: E402
    load_checkpoint,
    load_state_dict,
    save_torch_state_dict,
)
from videomamba_tpu_torch.data import TubeMaskingGenerator, make_clip_loader  # noqa: E402
from videomamba_tpu_torch.data.native import write_vraw  # noqa: E402
from videomamba_tpu_torch.determinism import configure_determinism  # noqa: E402
from videomamba_tpu_torch.models import block as block_mod  # noqa: E402
from videomamba_tpu_torch.models import mamba as mamba_mod  # noqa: E402
from videomamba_tpu_torch.models import mamba2 as mamba2_mod  # noqa: E402
from videomamba_tpu_torch.models.block import create_block  # noqa: E402
from videomamba_tpu_torch.models.mamba import Mamba, tensor_parallel_shards  # noqa: E402
from videomamba_tpu_torch.models.mamba2 import Mamba2  # noqa: E402
from videomamba_tpu_torch.models.refiner import BiMambaRefinerBlock  # noqa: E402
from videomamba_tpu_torch.models.presets import (  # noqa: E402
    M2_SSM_CFG,
    videomamba_base,
    videomamba_base_m2,
)
from videomamba_tpu_torch.ops import dispatch  # noqa: E402
from videomamba_tpu_torch.ops.causal_conv1d import causal_conv1d  # noqa: E402
from videomamba_tpu_torch.ops.kernels import _build  # noqa: E402
from videomamba_tpu_torch.ops.kernels import block_bwd as k7  # noqa: E402
from videomamba_tpu_torch.ops.kernels import block_fused as k4  # noqa: E402
from videomamba_tpu_torch.ops.kernels import causal_conv as k10  # noqa: E402
from videomamba_tpu_torch.ops.kernels import decode_step as k9  # noqa: E402
from videomamba_tpu_torch.ops.kernels import fused_add_norm as k2  # noqa: E402
from videomamba_tpu_torch.ops.kernels import mixer_bwd as k6  # noqa: E402
from videomamba_tpu_torch.ops.kernels import mixer_fused as k3  # noqa: E402
from videomamba_tpu_torch.ops.kernels import scan as k1  # noqa: E402
from videomamba_tpu_torch.ops.kernels import ssd_core as k11  # noqa: E402
from videomamba_tpu_torch.ops.kernels import ssd_mixer as k12  # noqa: E402
from videomamba_tpu_torch.ops.kernels import ssd_mixer_bwd as k13  # noqa: E402
from videomamba_tpu_torch.ops.kernels import ssd_pmixer as k14  # noqa: E402
from videomamba_tpu_torch.ops.norm import fused_add_norm  # noqa: E402
from videomamba_tpu_torch.ops.ssd import _prepare_dt, ssd_chunked  # noqa: E402
from videomamba_tpu_torch.parallel import (  # noqa: E402
    full_state_dict,
    init_train_state,
    make_mesh,
    sequence_parallel_mixer,
)
from videomamba_tpu_torch.parallel.sequence import (  # noqa: E402
    sequence_parallel_mixer_m2_shards,
    sequence_parallel_mixer_shards,
)
from videomamba_tpu_torch.parallel.train_step import make_train_step  # noqa: E402
from videomamba_tpu_torch.runtime import DecodeSession, StreamingSession  # noqa: E402
from videomamba_tpu_torch.utils.distributed import init_distributed_mode  # noqa: E402
from videomamba_tpu_torch.utils.precision import cast_module_for_compute  # noqa: E402

BASE = dict(batch=1, seqlen=1569, embed=768, d_inner=1536, d_state=16, dt_rank=48, width=4)
IMG = 224  # clip height and width: 14 x 14 patches of 16, 196 tokens a frame
SMALL = dict(BASE, embed=384, d_inner=768, dt_rank=24)
KERNEL_TOL = 1e-5
MODEL_TOL = 1e-4
BF16_TOL = 1e-2      # one bf16 ulp is 2^-8 of the largest element
BF16_MODEL_TOL = 2e-2  # such flips carried through 24 layers
GRAD_TOL = 2e-5      # the JAX package's gradient bar (tests/test_mixer_bwd.py:76)
BF16_GRAD_TOL = 2e-2  # its bf16 gradient bar (tests/test_block_bwd.py:115)
STEP_GRAD_TOL = 1e-4  # 24 layers of reordered fp32 sums, twice
BF16_STEP_TOL = 5e-2  # bf16 flips carried through 24 layers, forward and back
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12, "tf32": 495e12}
WRAPPERS = {"selective_scan": k1.selective_scan,
            "fused_add_norm": k2.fused_add_norm,
            "mixer_fused": k3.mixer_fused,
            "block_fused": k4.block_fused,
            "selective_scan_bwd": k1.selective_scan_bwd,
            "mixer_bwd": k6.mixer_bwd,
            "fused_add_norm_bwd": k2.fused_add_norm_bwd,
            "block_bwd": k7.block_bwd,
            "decode_stack": k9.decode_stack,
            "causal_conv": k10.causal_conv,
            "ssd_mixer": k12.ssd_mixer,
            "ssd_pmixer": k14.ssd_pmixer,
            "decode_stack_m2": k9.decode_stack_m2,
            "ssd_scan": k11.ssd_scan,
            "ssd_scan_bwd": k11.ssd_scan_bwd,
            "ssd_mixer_bwd": k13.ssd_mixer_bwd,
            "ssd_pmixer_bwd": k14.ssd_pmixer_bwd}
SOURCES = {
    "selective_scan": ("videomamba_tpu_torch/csrc/selective_scan.cu",
                       "videomamba_tpu/ops/pallas/scan.py:181"),
    "fused_add_norm": ("videomamba_tpu_torch/csrc/fused_add_norm.cu",
                       "videomamba_tpu/ops/pallas/fused_add_norm.py:59"),
    "mixer_fused": ("videomamba_tpu_torch/csrc/mixer_fused.cu",
                    "videomamba_tpu/ops/pallas/mixer_fused.py:324"),
    "block_fused": ("videomamba_tpu_torch/csrc/block_fused.cu",
                    "videomamba_tpu/ops/pallas/block_fused.py:494"),
    "selective_scan_bwd": ("videomamba_tpu_torch/csrc/selective_scan_bwd.cu",
                           "videomamba_tpu/ops/pallas/scan.py:523"),
    "mixer_bwd": ("videomamba_tpu_torch/csrc/mixer_bwd.cu",
                  "videomamba_tpu/ops/pallas/mixer_bwd.py:364"),
    "fused_add_norm_bwd": ("videomamba_tpu_torch/csrc/fused_add_norm_bwd.cu",
                           "videomamba_tpu/ops/pallas/fused_add_norm.py:185"),
    "block_bwd": ("videomamba_tpu_torch/csrc/block_bwd.cu",
                  "videomamba_tpu/ops/pallas/block_bwd.py:443"),
    "decode_stack": ("videomamba_tpu_torch/csrc/decode_step.cu",
                     "videomamba_tpu/ops/pallas/decode_step.py:193"),
    "causal_conv": ("videomamba_tpu_torch/csrc/causal_conv.cu",
                    "videomamba_tpu/ops/pallas/causal_conv.py:68"),
    "ssd_mixer": ("videomamba_tpu_torch/csrc/ssd_mixer.cu",
                  "videomamba_tpu/ops/pallas/ssd_scan.py:2328"),
    "ssd_pmixer": ("videomamba_tpu_torch/csrc/ssd_pmixer.cu",
                   "videomamba_tpu/ops/pallas/ssd_block.py:1583"),
    "decode_stack_m2": ("videomamba_tpu_torch/csrc/decode_step.cu",
                        "videomamba_tpu/ops/pallas/decode_step.py:418"),
    "ssd_scan": ("videomamba_tpu_torch/csrc/ssd_mixer.cu",
                 "videomamba_tpu/ops/pallas/ssd_scan.py:262"),
    "ssd_scan_bwd": ("videomamba_tpu_torch/csrc/ssd_core_bwd.cu",
                     "videomamba_tpu/ops/pallas/ssd_scan.py:618"),
    "ssd_mixer_bwd": ("videomamba_tpu_torch/csrc/ssd_mixer_bwd.cu",
                      "videomamba_tpu/ops/pallas/ssd_scan.py:1515"),
    "ssd_pmixer_bwd": ("videomamba_tpu_torch/csrc/ssd_pmixer_bwd.cu",
                       "videomamba_tpu/ops/pallas/ssd_block.py:885"),
}


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-8))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite values")
    err = rel_err(got, want)
    print(f"{name}: rel_err {err:.3e} (tol {tol:g})")
    check(err <= tol, f"{name}: rel_err {err:.3e} > {tol:g}")
    return float((got.double() - want.double()).abs().max())


def event_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean CUDA-event time of one call over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def host_ms(fn, repeats: int) -> float:
    """Median host time of a synchronised call."""
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def randn(shape, g, device, scale=1.0):
    return (scale * torch.randn(shape, generator=g)).to(device)


def kernel_inputs(cfg, device, seed=0):
    """Random inputs at the shapes the main path gives each kernel."""
    g = torch.Generator().manual_seed(seed)
    b, L, e, di = cfg["batch"], cfg["seqlen"], cfg["embed"], cfg["d_inner"]
    n, r, w = cfg["d_state"], cfg["dt_rank"], cfg["width"]
    xz = randn((b, L, 2 * di), g, device)
    xdbl = randn((b, L, r + 2 * n), g, device)
    a = -torch.arange(1, n + 1, dtype=torch.float32).expand(di, n).contiguous().to(device)
    dt_bias = torch.linspace(-6.9, -2.3, di).to(device)  # softplus^-1 of [1e-3, 0.1]
    scan = dict(u=randn((b, L, di), g, device), delta=randn((b, L, di), g, device, 0.5),
                A=a, B=xdbl[..., r:r + n], C=xdbl[..., r + n:], D=torch.ones(di, device=device),
                z=xz[..., di:], delta_bias=dt_bias, h0=randn((b, di, n), g, device, 0.1))
    norm = dict(x=randn((b, L, e), g, device), weight=1 + randn((e,), g, device, 0.1),
                bias=None, residual=randn((b, L, e), g, device), prenorm=True,
                residual_in_fp32=True, norm_type="rms")
    mixer = dict(x=xz[..., :di], z=xz[..., di:], conv_w=randn((di, w), g, device, 0.5),
                 conv_b=randn((di,), g, device, 0.5), x_proj_w=randn((r + 2 * n, di), g, device, 0.02),
                 dt_proj_w=randn((di, r), g, device, 0.02), dt_bias=dt_bias, A=a,
                 D=torch.ones(di, device=device), h0=randn((b, di, n), g, device, 0.1),
                 conv_state=randn((b, di, w), g, device))
    return {"selective_scan": scan, "fused_add_norm": norm, "mixer_fused": mixer}


def nbytes(*ts) -> int:
    """Bytes of the tensors given (a view counts its own elements)."""
    return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))


def bound(nbytes_moved: int, flops: dict) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of their type."""
    mem_ms = nbytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = sum(f / PEAK_FLOPS[kind] for kind, f in flops.items()) * 1e3
    return {"bound_ms": max(mem_ms, ops_ms),
            "bound_by": "bytes" if mem_ms >= ops_ms else "operations"}


def scan_flops(b, L, d, n, per_step=6):
    return {"fp32": per_step * b * L * n * d}


def mixer_flops(b, L, di, n, r, w, wdtype, backward=False):
    """Conv, x_proj and dt_proj (each three times in the backward: the
    recompute, the cotangent product, the weight gradient) and the walk."""
    p = r + 2 * n
    times = 3 if backward else 1
    products = times * 2 * b * L * (di * p + r * di)
    kind = "bf16" if wdtype == torch.bfloat16 else "fp32"
    fp32 = times * 2 * w * b * L * di + scan_flops(b, L, di, n, 26 if backward else 6)["fp32"]
    return {"fp32": fp32 + (products if kind == "fp32" else 0),
            **({"bf16": products} if kind == "bf16" else {})}


def time_against_plain(name, fn, plain, kw, tol, flops, iters=20, plain_iters=3,
                       repeat_identical=False):
    """One kernel call against its plain version on the same inputs (every
    output, dtype and values), then both timed; returns the kernels-line
    entries max_abs_err, ms, plain_ms, bound_ms, bound_by and library_ms.
    With ``repeat_identical`` a second call must give bit-identical outputs."""
    out = fn(**kw)
    torch.cuda.synchronize()
    if repeat_identical:
        again = fn(**kw)
        torch.cuda.synchronize()
        check(all(a is None and b is None or torch.equal(a, b) for a, b in zip(out, again)),
              f"{name}: two runs on the same inputs differ")
        print(f"kernel {name}: two runs bit-identical")
    ref = plain(**kw)
    errs = []
    for i, (o, p) in enumerate(zip(out, ref)):
        check((o is None) == (p is None), f"{name}[{i}]: None where plain is not")
        if o is None:
            continue
        check(o.dtype == p.dtype, f"{name}[{i}]: dtype {o.dtype} != plain {p.dtype}")
        errs.append(check_close(f"kernel {name}[{i}]", o, p, tol))
    ms = event_ms(lambda: fn(**kw), iters)
    plain_ms = event_ms(lambda: plain(**kw), plain_iters, warmup=1) if plain_iters else None
    result = {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
              **bound(nbytes(*kw.values(), *out), flops), "library_ms": None}
    plain_txt = "not timed" if plain_ms is None else f"{plain_ms:.4f} ms"
    print(f"kernel {name}: {ms:.4f} ms, plain {plain_txt}, "
          f"bound {result['bound_ms']:.4f} ms ({result['bound_by']})")
    return result


def phase_kernels(cfg, device):
    """K1-K3 (fp32) each against its plain version on the same inputs, and timed."""
    b, L, e, di = cfg["batch"], cfg["seqlen"], cfg["embed"], cfg["d_inner"]
    n, r, w = cfg["d_state"], cfg["dt_rank"], cfg["width"]
    plains = {"selective_scan": k1.selective_scan_plain,
              "fused_add_norm": k2.fused_add_norm_plain,
              "mixer_fused": k3.mixer_fused_plain}
    flops = {"selective_scan": scan_flops(b, L, di, n),
             "fused_add_norm": {"fp32": 8 * b * L * e},
             "mixer_fused": mixer_flops(b, L, di, n, r, w, torch.float32)}
    results = {}
    for name, kw in kernel_inputs(cfg, device).items():
        results[name] = time_against_plain(name, WRAPPERS[name], plains[name], kw, KERNEL_TOL,
                                           flops[name], repeat_identical=True)
        if name == "mixer_fused":
            launch_split("mixer_fused fp32 Base", WRAPPERS[name], kw)
        if name == "selective_scan":
            launch_split(f"selective_scan fp32 Base B={b} (chunk {k1.walk_chunk(b, L, di)})",
                         WRAPPERS[name], kw)
    return results


def launch_split(label, fn, kw, top=10, bound_ms=None, iters=10):
    """Each launch's device time a call of a multi-launch kernel (K1, K3-K8,
    K10: the split walks' chunk launches, pass and output walk, the
    reductions, the product tiles, K8's row pass and column sum), the
    ``top`` longest; with ``bound_ms``, the call's share of that bound."""
    _, dev = device_ms(lambda: fn(**kw), iters=iters, label=label, top=top)
    if dev is None:
        print(f"{label}: device time not measured")
        return
    share = ("" if bound_ms is None
             else f", {100 * bound_ms / dev:.1f} % of its {bound_ms:.4f} ms bound")
    print(f"{label}: {dev:.4f} ms of device kernels a call{share}")


def block_inputs(cfg, device, dtype, seed=3):
    """K4 operands at the shapes a Block gives it: weights in ``dtype``,
    nonzero h0 and conv_state."""
    g = torch.Generator().manual_seed(seed)
    b, L, e, di = cfg["batch"], cfg["seqlen"], cfg["embed"], cfg["d_inner"]
    n, r, w = cfg["d_state"], cfg["dt_rank"], cfg["width"]
    a = -torch.arange(1, n + 1, dtype=torch.float32).expand(di, n).contiguous().to(device)
    return dict(
        hidden=randn((b, L, e), g, device).to(dtype), residual=randn((b, L, e), g, device),
        norm_w=1 + randn((e,), g, device, 0.1), norm_b=None,
        in_proj_w=randn((2 * di, e), g, device, e ** -0.5).to(dtype),
        out_proj_w=randn((e, di), g, device, di ** -0.5).to(dtype),
        conv_w=randn((di, w), g, device, 0.5).to(dtype),
        conv_b=randn((di,), g, device, 0.5).to(dtype),
        x_proj_w=randn((r + 2 * n, di), g, device, di ** -0.5).to(dtype),
        dt_proj_w=randn((di, r), g, device, r ** -0.5).to(dtype),
        dt_bias=torch.linspace(-6.9, -2.3, di).to(device), A=a,
        D=torch.ones(di, device=device), h0=randn((b, di, n), g, device, 0.1),
        conv_state=randn((b, di, w), g, device),
    )


def block_flops(cfg, dtype, backward=False):
    """K4's operations, or with ``backward`` K7's: the mixer's (three times
    over in the backward) and in_proj / out_proj (the backward recomputes
    in_proj and runs four more products of the same sizes: g_y, dnormed,
    dWout, dWin), plus the norm."""
    b, L, e, di = cfg["batch"], cfg["seqlen"], cfg["embed"], cfg["d_inner"]
    n, r, w = cfg["d_state"], cfg["dt_rank"], cfg["width"]
    mixer = mixer_flops(b, L, di, n, r, w, dtype, backward=backward)
    kind = "bf16" if dtype == torch.bfloat16 else "fp32"
    per_product = 2 * b * L * e * di
    mixer[kind] = mixer.get(kind, 0) + per_product * (8 if backward else 3)
    mixer["fp32"] += (20 if backward else 8) * b * L * e
    return mixer


def phase_bf16_kernels(device):
    """K4 at bf16 (Base) and fp32 (Small), K2 at bf16, against plain."""
    base = block_inputs(BASE, device, torch.bfloat16)
    result = time_against_plain(
        "block_fused bf16 Base", k4.block_fused, k4.block_fused_plain, base, BF16_TOL,
        block_flops(BASE, torch.bfloat16), repeat_identical=True)
    launch_split("block_fused bf16 Base", k4.block_fused, base)
    small = block_inputs(SMALL, device, torch.float32)
    time_against_plain("block_fused fp32 Small", k4.block_fused, k4.block_fused_plain, small,
                       KERNEL_TOL, block_flops(SMALL, torch.float32), repeat_identical=True)
    launch_split("block_fused fp32 Small", k4.block_fused, small)
    norm = kernel_inputs(BASE, device)["fused_add_norm"]
    time_against_plain("fused_add_norm bf16 x, fp32 residual", k2.fused_add_norm,
                       k2.fused_add_norm_plain, dict(norm, x=norm["x"].bfloat16()), BF16_TOL,
                       {"fp32": 8 * norm["x"].numel()})
    return result


def build_models(device, **overrides):
    """Base fp32 with kernels on, and the same weights on the plain path."""
    g = torch.Generator().manual_seed(0)
    fast = videomamba_base(pool_type="avg", device=device, generator=g, **overrides).eval()
    plain = videomamba_base(pool_type="avg", device=device, fused_add_norm=False,
                            ssm_cfg={"use_fast_path": False}, **overrides).eval()
    load_state_dict(plain, fast.state_dict())
    return fast, plain


def launches():
    return {name: w.launches for name, w in WRAPPERS.items()}


def zero_launches():
    for w in WRAPPERS.values():
        w.launches = 0


def delta(after, before):
    return {k: after[k] - before[k] for k in after}


def phase_forward(fast, plain, clip, depth):
    before = launches()
    x_vis, x_pool = fast(clip)
    torch.cuda.synchronize()
    used = delta(launches(), before)
    print(f"forward launches: {used}")
    check(used["fused_add_norm"] == depth + 1 and used["mixer_fused"] == depth
          and used["block_fused"] == 0,
          f"forward: expected K2={depth + 1}, K3={depth}, K4=0 launches, got {used}")
    t_tokens = clip.shape[2] // fast.patch_embed.tubelet_size
    tokens = t_tokens * fast.patch_embed.num_patches
    check(x_vis.shape == (clip.shape[0], tokens, fast.embed_dim), f"x_vis shape {tuple(x_vis.shape)}")
    check(x_pool.shape == (clip.shape[0], 1, fast.embed_dim), f"x_pool shape {tuple(x_pool.shape)}")
    p_vis, p_pool = plain(clip)
    check_close("forward x_vis vs plain", x_vis, p_vis, MODEL_TOL)
    check_close("forward x_pool vs plain", x_pool, p_pool, MODEL_TOL)
    return x_vis


def phase_stream(fast, clip, full_vis, chunk_frames, tol=MODEL_TOL):
    session = StreamingSession(fast, batch_size=clip.shape[0])
    outs = []
    for t0 in range(0, clip.shape[2], chunk_frames):
        x_vis, x_pool = session.process(clip[:, :, t0:t0 + chunk_frames])
        check(bool(torch.isfinite(x_pool).all()), "stream: non-finite x_pool")
        for conv, ssm in session.state:
            check(conv.dtype == ssm.dtype == torch.float32,
                  f"stream: states are {conv.dtype}, {ssm.dtype}, not fp32")
        outs.append(x_vis)
    torch.cuda.synchronize()
    check_close(f"stream stitched vs full clip ({full_vis.dtype})", torch.cat(outs, dim=1),
                full_vis, tol)


def plain_blocks(model, tokens):
    """The encoder from the first Block's input tokens on: every Block's
    whole-block plain version, then the final norm's plain version."""
    hidden, residual = tokens, torch.zeros_like(tokens, dtype=torch.float32)
    bsz = tokens.shape[0]
    for layer in model.layers:
        mx = layer.mixer
        zeros = dict(device=tokens.device)
        hidden, residual, _ = k4.block_fused_plain(
            hidden, residual,
            h0=torch.zeros((bsz, mx.d_inner, mx.d_state), dtype=torch.float32, **zeros),
            conv_state=torch.zeros((bsz, mx.d_inner, mx.d_conv), dtype=tokens.dtype, **zeros),
            **layer.block_fused_weights())
    return k2.fused_add_norm_plain(
        hidden, model.norm.weight, model.norm.bias, residual=residual,
        residual_in_fp32=model.residual_in_fp32, eps=model.norm_epsilon,
        norm_type="rms" if model.rms_norm else "layer")


def phase_bf16_forward(model, clip, fp32_vis, depth):
    """bf16 Base full clip, kernels on, against the plain Blocks."""
    seen = {}

    def keep_tokens(module, args):
        seen.setdefault("tokens", args[0])

    hook = model.layers[0].register_forward_pre_hook(keep_tokens)
    before = launches()
    x_vis, x_pool = model(clip)
    torch.cuda.synchronize()
    used = delta(launches(), before)
    hook.remove()
    print(f"bf16 forward launches: {used}")
    want = {"selective_scan": 0, "fused_add_norm": 1, "mixer_fused": 0, "block_fused": depth}
    check(all(used[k] == v for k, v in want.items()),
          f"bf16 forward: expected K4={depth}, K2=1, K1=K3=0 launches, got {used}")
    check(x_vis.dtype == torch.bfloat16 and x_vis.shape == fp32_vis.shape,
          f"bf16 x_vis {x_vis.dtype} {tuple(x_vis.shape)}")
    check(bool(torch.isfinite(x_pool).all()), "bf16 forward: non-finite x_pool")
    ref = plain_blocks(model, seen["tokens"])[:, 1:]  # CLS leads
    check_close("bf16 forward x_vis vs plain Blocks", x_vis, ref, BF16_MODEL_TOL)
    diff = (x_vis.double() - fp32_vis.double()).abs()
    print(f"bf16 vs fp32 x_vis: max rel {float(diff.max() / fp32_vis.abs().max()):.3e}, "
          f"mean rel {float(diff.mean() / fp32_vis.double().abs().mean()):.3e}")
    return x_vis


def phase_unfused(cfg, device):
    g = torch.Generator().manual_seed(1)
    layer = Mamba(cfg["embed"], conv_bias=False, device=device, generator=g).eval()
    plain = Mamba(cfg["embed"], conv_bias=False, use_fast_path=False, device=device).eval()
    plain.load_state_dict(layer.state_dict())
    check(not layer._use_fused_mixer(), "unfused: the layer took the fused branch")
    x = randn((cfg["batch"], cfg["seqlen"], cfg["embed"]), g, device)
    before = launches()["selective_scan"]
    y = layer(x)
    torch.cuda.synchronize()
    check(launches()["selective_scan"] > before, "unfused: K1 was not launched")
    check_close("unfused mixer vs plain", y, plain(x), KERNEL_TOL)


def phase_bwd_kernels(device):
    """Checkpoints of K1 and K3, K1 and K3 at bf16, and K5, K6, K8 against
    their plain versions at Base shapes; returns the kernels-line entries of
    K5, K6 and K8 (fp32)."""
    b, L, e, di = BASE["batch"], BASE["seqlen"], BASE["embed"], BASE["d_inner"]
    n, r, w = BASE["d_state"], BASE["dt_rank"], BASE["width"]
    g = torch.Generator().manual_seed(11)
    inputs = kernel_inputs(BASE, device, seed=5)
    results = {}
    bf16 = torch.bfloat16
    for dtype, tol, gtol in ((torch.float32, KERNEL_TOL, GRAD_TOL), (bf16, BF16_TOL, BF16_GRAD_TOL)):
        label = "fp32" if dtype == torch.float32 else "bf16"
        sk = {k: (v.to(dtype) if k in ("u", "delta", "z", "B", "C") else v)
              for k, v in inputs["selective_scan"].items()}
        y, h, ckpt = k1.selective_scan(**sk, checkpoints=True)
        again = k1.selective_scan(**sk, checkpoints=True)
        torch.cuda.synchronize()
        check(all(torch.equal(a, c) for a, c in zip((y, h, ckpt), again)),
              f"K1 {label}: two runs on the same inputs differ")
        want = k1.selective_scan_plain(**sk, checkpoints=True)
        for name, got, ref in zip(("y", "h_last", "checkpoints"), (y, h, ckpt), want):
            check_close(f"K1 {label} {name}", got, ref, tol if name == "y" else KERNEL_TOL)
        kw = dict(sk, ckpt=ckpt, g_out=randn((b, L, di), g, device).to(dtype),
                  g_hlast=randn((b, di, n), g, device, 0.3))
        del kw["h0"]
        res = time_against_plain(f"selective_scan_bwd {label}", k1.selective_scan_bwd,
                                 k1.selective_scan_bwd_plain, kw, gtol,
                                 scan_flops(b, L, di, n, 26), plain_iters=1, repeat_identical=True)
        launch_split(f"selective_scan_bwd {label} B={b} (chunk {k1.walk_bwd_chunk(b, L, di)})",
                     k1.selective_scan_bwd, kw, top=8)
        if dtype == torch.float32:
            results["selective_scan_bwd"] = res
        scan_batch4(device, dtype, label, tol, gtol)
        # The route without D, z and delta_bias: softplus off, so delta is the
        # (positive) step itself; checkpoints from the matching forward.
        bare = dict(sk, D=None, z=None, delta_bias=None, softplus_delta=False,
                    delta=k1.softplus(sk["delta"].float() + sk["delta_bias"]).to(dtype))
        _, _, bare_ckpt = k1.selective_scan(**bare, checkpoints=True)
        bare = dict(bare, ckpt=bare_ckpt, g_out=kw["g_out"], g_hlast=None)
        del bare["h0"]
        time_against_plain(f"selective_scan_bwd {label} without D, z, delta_bias",
                           k1.selective_scan_bwd, k1.selective_scan_bwd_plain, bare, gtol,
                           scan_flops(b, L, di, n, 26), plain_iters=1, repeat_identical=True)

        mk = inputs["mixer_fused"]
        if dtype == bf16:
            mk = {k: (v.to(bf16) if k in ("x", "z", "conv_w", "conv_b", "x_proj_w", "dt_proj_w",
                                          "conv_state") else v) for k, v in mk.items()}
        y, h, ckpt = k3.mixer_fused(**mk, checkpoints=True)
        torch.cuda.synchronize()
        want = k3.mixer_fused_plain(**mk, checkpoints=True)
        for name, got, ref in zip(("y", "h_last", "checkpoints"), (y, h, ckpt), want):
            check_close(f"K3 {label} {name}", got, ref, tol if name == "y" else
                        (KERNEL_TOL if dtype == torch.float32 else BF16_TOL))
        kw = dict(mk, ckpt=ckpt, g_y=randn((b, L, di), g, device).to(dtype),
                  g_hlast=randn((b, di, n), g, device, 0.3))
        del kw["h0"]
        res = time_against_plain(f"mixer_bwd {label}", k6.mixer_bwd, k6.mixer_bwd_plain, kw, gtol,
                                 mixer_flops(b, L, di, n, r, w, dtype, backward=True),
                                 plain_iters=1, repeat_identical=True)
        launch_split(f"mixer_bwd {label} B={b} (chunk {k1.walk_bwd_chunk(b, L, di)})",
                     k6.mixer_bwd, kw, top=20)
        if dtype == torch.float32:
            results["mixer_bwd"] = res
        # B=4, the training batch: the split reverse walk at its other chunk.
        mk4 = {k: v.to(dtype) if k in ("x", "z", "conv_w", "conv_b", "x_proj_w", "dt_proj_w",
                                       "conv_state") else v
               for k, v in kernel_inputs(dict(BASE, batch=4), device, seed=5)["mixer_fused"].items()}
        *_, ckpt4 = k3.mixer_fused(**mk4, checkpoints=True)
        kw4 = dict(mk4, ckpt=ckpt4, g_y=randn((4, L, di), g, device).to(dtype),
                   g_hlast=randn((4, di, n), g, device, 0.3))
        del kw4["h0"]
        time_against_plain(f"mixer_bwd {label} B=4", k6.mixer_bwd, k6.mixer_bwd_plain, kw4, gtol,
                           mixer_flops(4, L, di, n, r, w, dtype, backward=True), iters=10,
                           plain_iters=1, repeat_identical=True)
        launch_split(f"mixer_bwd {label} B=4 (chunk {k1.walk_bwd_chunk(4, L, di)})",
                     k6.mixer_bwd, kw4, top=20)
        del mk4, kw4, ckpt4

    nk = inputs["fused_add_norm"]
    kw = dict(x=nk["x"], weight=nk["weight"], residual=nk["residual"],
              g_out=randn((b, L, e), g, device), g_resout=randn((b, L, e), g, device),
              prenorm=True, norm_type="rms")
    results["fused_add_norm_bwd"] = time_against_plain(
        "fused_add_norm_bwd fp32 rms prenorm", k2.fused_add_norm_bwd,
        k2.fused_add_norm_bwd_plain, kw, KERNEL_TOL, {"fp32": 12 * b * L * e},
        repeat_identical=True)
    launch_split("fused_add_norm_bwd fp32 B=1", k2.fused_add_norm_bwd, kw,
                 bound_ms=results["fused_add_norm_bwd"]["bound_ms"], iters=30)
    for name, fn in (("fused_add_norm_bwd", k2.fused_add_norm_bwd),
                     ("fused_add_norm", k2.fused_add_norm)):
        args = kw if fn is k2.fused_add_norm_bwd else inputs["fused_add_norm"]
        wall, dev = device_ms(lambda: fn(**args), iters=50)
        dev_txt = "not measured" if dev is None else f"{dev:.4f} ms"
        print(f"kernel {name} fp32: device {dev_txt} a call (profiler), "
              f"host {wall:.4f} ms a call")
    bkw = dict(kw, x=kw["x"].bfloat16(), g_out=kw["g_out"].bfloat16())
    res = time_against_plain(
        "fused_add_norm_bwd bf16 x, fp32 residual", k2.fused_add_norm_bwd,
        k2.fused_add_norm_bwd_plain, bkw, BF16_TOL, {"fp32": 12 * b * L * e},
        repeat_identical=True)
    launch_split("fused_add_norm_bwd bf16 x B=1", k2.fused_add_norm_bwd, bkw,
                 bound_ms=res["bound_ms"], iters=30)
    # The cotangent at its own dtype (fp32) beside a bf16 x: the fp32
    # dweight and dbias hold the fp32 bar.
    fkw = dict(kw, x=kw["x"].bfloat16())
    got = k2.fused_add_norm_bwd(**fkw)
    want = k2.fused_add_norm_bwd_plain(**fkw)
    check_close("kernel fused_add_norm_bwd bf16 x, fp32 g_out: dx", got[0], want[0], BF16_TOL)
    for i, name in ((1, "dweight"), (2, "dbias"), (3, "dresidual")):
        check_close(f"kernel fused_add_norm_bwd bf16 x, fp32 g_out: {name}", got[i], want[i],
                    KERNEL_TOL)
    b4 = 4
    kw4 = dict(x=randn((b4, L, e), g, device), weight=kw["weight"],
               residual=randn((b4, L, e), g, device), g_out=randn((b4, L, e), g, device),
               g_resout=randn((b4, L, e), g, device), prenorm=True, norm_type="rms")
    res = time_against_plain("fused_add_norm_bwd fp32 B=4", k2.fused_add_norm_bwd,
                             k2.fused_add_norm_bwd_plain, kw4, KERNEL_TOL,
                             {"fp32": 12 * b4 * L * e}, plain_iters=1, repeat_identical=True)
    launch_split("fused_add_norm_bwd fp32 B=4", k2.fused_add_norm_bwd, kw4,
                 bound_ms=res["bound_ms"], iters=30)
    del kw4
    return results


def scan_batch4(device, dtype, label, tol, gtol):
    """K1 (with checkpoints) and K5 at Base widths, batch 4, against their
    plain versions (not timed), each twice bit-identical and timed, with
    each launch's device time a call."""
    b, L, di, n = 4, BASE["seqlen"], BASE["d_inner"], BASE["d_state"]
    sk = {k: (v.to(dtype) if k in ("u", "delta", "z", "B", "C") else v)
          for k, v in kernel_inputs(dict(BASE, batch=b), device, seed=6)["selective_scan"].items()}
    time_against_plain(f"selective_scan {label} B=4", k1.selective_scan, k1.selective_scan_plain,
                       dict(sk, checkpoints=True), tol, scan_flops(b, L, di, n), iters=10,
                       plain_iters=0, repeat_identical=True)
    launch_split(f"selective_scan {label} B=4 (chunk {k1.walk_chunk(b, L, di)})",
                 k1.selective_scan, dict(sk, checkpoints=True), top=8)
    *_, ckpt = k1.selective_scan(**sk, checkpoints=True)
    g = torch.Generator().manual_seed(12)
    kw = dict({k: v for k, v in sk.items() if k != "h0"}, ckpt=ckpt,
              g_out=randn((b, L, di), g, device).to(dtype),
              g_hlast=randn((b, di, n), g, device, 0.3))
    time_against_plain(f"selective_scan_bwd {label} B=4", k1.selective_scan_bwd,
                       k1.selective_scan_bwd_plain, kw, gtol, scan_flops(b, L, di, n, 26),
                       iters=10, plain_iters=0, repeat_identical=True)
    launch_split(f"selective_scan_bwd {label} B=4 (chunk {k1.walk_bwd_chunk(b, L, di)})",
                 k1.selective_scan_bwd, kw, top=8)


def train_batch(batch, device, seed=2, zero_target=True):
    """A seeded clip and a target for the patch tokens: zero, as in the bench
    recipe, or seeded noise. With a zero target the loss is the mean square of
    RMS-normed tokens, about 1 whatever the weights, so every gradient below
    the final norm is cancellation noise; comparisons use a noise target."""
    g = torch.Generator().manual_seed(seed)
    video = torch.randn((batch, 3, 8, IMG, IMG), generator=g)
    shape = (batch, 8 * (IMG // 16) ** 2, BASE["embed"])
    target = torch.zeros(shape) if zero_target else torch.randn(shape, generator=g)
    return {"video": video.to(device), "target": target.to(device)}


def grads_of(model):
    """Gradients by name of the parameters the loss reached (the pool norm's
    are not: the default loss reads the patch tokens)."""
    return {name: p.grad.detach().clone() for name, p in model.named_parameters()
            if p.grad is not None}


def compare_grads(label, got, want, tol):
    """Every parameter's gradient within ``tol`` (rel_err); prints the worst
    and the mean relative error over parameters."""
    errs = {}
    check(set(got) == set(want), f"{label}: gradients of {set(got) ^ set(want)} on one side only")
    for name, ref in want.items():
        check(bool(torch.isfinite(got[name]).all()), f"{label}: non-finite gradient of {name}")
        errs[name] = rel_err(got[name], ref)
    worst = max(errs, key=errs.get)
    mean = statistics.mean(
        float((got[k].double() - want[k].double()).abs().mean()
              / want[k].double().abs().mean().clamp_min(1e-30)) for k in want)
    print(f"{label}: gradients max rel_err {errs[worst]:.3e} ({worst}), "
          f"mean rel {mean:.3e} (tol {tol:g})")
    check(errs[worst] <= tol, f"{label}: {worst} rel_err {errs[worst]:.3e} > {tol:g}")


def base_model(device, sd=None, **overrides):
    model = videomamba_base(pool_type="avg", device=device,
                            generator=torch.Generator().manual_seed(0), **overrides)
    if sd is not None:
        load_state_dict(model, sd)
    return model


def adamw(model):
    """The bench recipe's optimizer (bench.py:243): AdamW, lr 1e-4, wd 0.05."""
    return torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=0.05)


def expect_launches(label, used, **want):
    print(f"{label} launches: {used}")
    for name, count in want.items():
        check(used[name] == count, f"{label}: {name} launched {used[name]} times, expected {count}")


def phase_train_fp32(device, batch, depth):
    """One fp32 step: kernels against the plain path, the opt-in backward
    routes against the default, remat against no remat."""
    fast = base_model(device)
    sd0 = {k: v.detach().clone() for k, v in fast.state_dict().items()}
    step = make_train_step(fast, adamw(fast))
    before = launches()
    metrics = step(batch, torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    expect_launches("fp32 train step", delta(launches(), before),
                    fused_add_norm=depth + 1, mixer_fused=depth, mixer_bwd=depth,
                    selective_scan_bwd=0, fused_add_norm_bwd=0, block_fused=0)
    grads = grads_of(fast)
    loss = metrics["loss"]
    check(bool(torch.isfinite(loss)), "fp32 train step: non-finite loss")

    plain = base_model(device, sd0, fused_add_norm=False, ssm_cfg={"use_fast_path": False})
    plain_metrics = make_train_step(plain, adamw(plain))(batch)
    torch.cuda.synchronize()
    check_close("fp32 train step loss vs plain", loss.reshape(1),
                plain_metrics["loss"].reshape(1), 1e-5)
    compare_grads("fp32 train step vs plain", grads, grads_of(plain), STEP_GRAD_TOL)
    del plain, plain_metrics
    torch.cuda.empty_cache()

    load_state_dict(fast, sd0)
    os.environ["VIDEOMAMBA_MIXER_BWD"] = "composite"
    os.environ["VIDEOMAMBA_NORM_BWD"] = "pallas"
    try:
        before = launches()
        step(batch)
        torch.cuda.synchronize()
    finally:
        del os.environ["VIDEOMAMBA_MIXER_BWD"], os.environ["VIDEOMAMBA_NORM_BWD"]
    expect_launches("fp32 train step, composite + norm kernel", delta(launches(), before),
                    selective_scan_bwd=depth, fused_add_norm_bwd=depth + 1, mixer_bwd=0,
                    mixer_fused=depth)
    compare_grads("composite + K8 routes vs default", grads_of(fast), grads, STEP_GRAD_TOL)
    del fast, step
    torch.cuda.empty_cache()

    remat_grads = []
    for use_checkpoint in (True, False):
        model = base_model(device, sd0, drop_path_rate=0.1, use_checkpoint=use_checkpoint,
                           checkpoint_num=depth)
        make_train_step(model, adamw(model))(
            batch, torch.Generator().manual_seed(7))
        remat_grads.append(grads_of(model))
        del model
    compare_grads("checkpoint_num=24, drop_path 0.1 vs no remat", *remat_grads, 1e-6)
    torch.cuda.empty_cache()
    return sd0, grads


@contextlib.contextmanager
def plain_versions():
    """Every kernel the training route and the m2 serving route call,
    swapped for its plain version (same rounding points, no kernel): the
    reference of the bf16 step and of the m2 bf16 forward."""
    swaps = [(mamba_mod, "mixer_fused", k3.mixer_fused_plain),
             (mamba2_mod, "ssd_pmixer", k14.ssd_pmixer_plain),
             (mamba2_mod, "ssd_mixer", k12.ssd_mixer_plain),
             (mamba_mod, "mixer_bwd", k6.mixer_bwd_plain),
             (block_mod, "block_fused", k4.block_fused_plain),
             (block_mod, "block_bwd", k7.block_bwd_plain),
             (k2, "fused_add_norm", k2.fused_add_norm_plain),
             (k2, "fused_add_norm_bwd", k2.fused_add_norm_bwd_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def timed_steps(step, batch, label, warm=2, timed=5):
    """``warm + timed`` steps, each loss finite; the median host ms of the
    timed ones and the peak device memory."""
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(warm + timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(batch)
        torch.cuda.synchronize()
        if i >= warm:
            times.append((time.perf_counter() - t0) * 1e3)
        check(bool(torch.isfinite(metrics["loss"])), f"{label}: non-finite loss at step {i}")
    ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{label}: {ms:.3f} ms a step (median of {timed}, steps {times}), "
          f"peak memory {peak:.2f} GiB, last loss {float(metrics['loss']):.6f}")
    return ms, peak


def phase_train_bf16(device, sd0, fp32_grads, batch, depth):
    """The bench recipe at B=2 against the same model on plain versions."""
    model = base_model(device, sd0)
    step = make_train_step(model, adamw(model), compute_dtype=torch.bfloat16)
    before = launches()
    metrics = step(batch, torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    expect_launches("bf16 train step", delta(launches(), before),
                    fused_add_norm=depth + 1, mixer_fused=depth, mixer_bwd=depth,
                    block_fused=0)
    check(all(p.dtype == torch.float32 for p in model.parameters()), "bf16 step: masters not fp32")
    grads = grads_of(model)
    load_state_dict(model, sd0)
    with plain_versions():
        before = launches()
        plain_metrics = step(batch, torch.Generator().manual_seed(1))
        torch.cuda.synchronize()
        check(launches() == before, "bf16 plain-version step launched a kernel")
    check_close("bf16 train step loss vs plain versions", metrics["loss"].reshape(1),
                plain_metrics["loss"].reshape(1), BF16_TOL)
    compare_grads("bf16 train step vs plain versions", grads, grads_of(model), BF16_STEP_TOL)
    worst = max(rel_err(grads[k], fp32_grads[k]) for k in fp32_grads)
    mean = statistics.mean(float((grads[k].double() - fp32_grads[k].double()).abs().mean()
                                 / fp32_grads[k].double().abs().mean().clamp_min(1e-30))
                           for k in fp32_grads)
    print(f"bf16 vs fp32 train-step gradients: max rel {worst:.3e}, mean rel {mean:.3e}")
    return model

def kernel_ms_by_name(fn, iters: int):
    """(host wall ms, {device activity name: ms}) per call of ``fn`` over
    ``iters`` calls under torch.profiler."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    by_name = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA and not getattr(evt, "is_user_annotation", False):
            ms = evt.time_range.elapsed_us() / 1e3 / iters
            by_name[evt.name] = by_name.get(evt.name, 0.0) + ms
    return wall, by_name


def device_ms(fn, iters: int, label: str = "", top: int = 0):
    """(host wall ms, device kernel ms) per call of ``fn`` over ``iters``
    calls under torch.profiler; the kernel time is the sum of the device
    kernels' own intervals (one stream: they do not overlap). None for the
    device time when the profiler saw no device kernel. With ``top``, prints
    the ``top`` kernels by device time per call."""
    wall, by_name = kernel_ms_by_name(fn, iters)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {label}: {ms:.4f} ms a call in {name[:90]}")
    kernel_ms = sum(by_name.values())
    return wall, (kernel_ms if kernel_ms > 0 else None)


def print_parts(label, parts):
    print(f"{label}: " + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
          + f" (device ms a call; total {sum(parts.values()):.4f})")


# K14's product tile kernels: the first launch of one in a call is in_proj,
# the second out_proj.
PRODUCT_TILES = ("gemm_nt_kernel", "gemm_nt_bf16_kernel", "gemm_nt_wide_kernel",
                 "product_kernel")


def pmixer_split(label, kw, iters: int = 10):
    """K14's forward by launch under torch.profiler, device ms a call:
    in_proj (a product tile launch after torch's ops), the span (K12's
    launches), out_proj (a product tile launch after the span) and torch's
    own ops (the dt columns, the decay cumsum). The profiler can lose a
    launch's record, so each product is averaged over the launches it saw."""
    from torch.autograd import DeviceType

    fn = lambda: k14.ssd_pmixer(**kw)  # noqa: E731
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evts = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda e: e.time_range.start)
    ms, seen, last = {}, {}, "torch ops"
    for e in evts:
        if any(t in e.name for t in PRODUCT_TILES):
            part = "out_proj" if last == "span" else "in_proj"
        elif "ssd_" in e.name or "conv_silu" in e.name:
            part = "span"
        else:
            part = "torch ops"
        ms[part] = ms.get(part, 0.0) + e.time_range.elapsed_us() / 1e3
        seen[part] = seen.get(part, 0) + 1
        last = part
    print_parts(label, {p: v / (seen[p] if p.endswith("_proj") else iters)
                        for p, v in ms.items()})


def matmul_yardstick(cfg, device):
    """torch.matmul (TF32 off) at K14's two product shapes: event ms and
    TFLOP/s, the yardstick of its product tiles."""
    rows = cfg["batch"] * cfg["seqlen"]
    di = cfg["nheads"] * cfg["hdim"]
    zx = 2 * di + 2 * cfg["ngroups"] * cfg["d_state"]
    g = torch.Generator().manual_seed(5)
    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        for name, (m, k, n) in (("in_proj", (rows, cfg["embed"], zx)),
                                ("out_proj", (rows, di, cfg["embed"]))):
            a = randn((m, k), g, device).to(dtype)
            w = randn((n, k), g, device).to(dtype)
            ms = event_ms(lambda: torch.matmul(a, w.t()), 50)
            print(f"torch.matmul {name} {tag} ({m} x {k} by {k} x {n}): {ms:.4f} ms, "
                  f"{2 * m * n * k / ms / 1e9:.1f} TFLOP/s (K14's yardstick)")


# Parts of K13's span, by kernel-name fragment (first match wins).
K13_PARTS = (("conv_silu", "conv recompute"), ("epilogue_bwd", "epilogue"),
             ("ssd_cb", "C B^T tiles"), ("dhin", "dh_in"), ("state_pass", "reverse pass"),
             ("kside", "k-side tiles"), ("qside", "q-side tiles"),
             ("group_sum", "group sum"), ("dsilu", "dsilu"), ("conv_", "conv backward"))


# K14's backward's products in the order they run.
PMIXER_BWD_ORDER = ("in_proj recompute", "dWout", "dgated", "dhidden", "dWin")


def pmixer_bwd_split(label, kw, cfg, iters: int = 5):
    """K14's backward launches, device ms a call under the profiler, by part:
    in_proj's recompute (the product before the gate), dWout and dgated
    (the products after it), K13's span, dhidden and dWin (the products
    after the span), the ordered sums of split contractions, memsets and
    torch's own ops; each product's TFLOP/s. The profiler can lose a
    launch's record, so each product is averaged over the launches it saw."""
    from torch.autograd import DeviceType

    fn = lambda: k14.ssd_pmixer_bwd(**kw)  # noqa: E731
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evts = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda e: e.time_range.start)
    ms, seen = {}, {}
    pos = 0  # the next product's place in PMIXER_BWD_ORDER
    for e in evts:
        name = e.name
        if "product_kernel" in name:
            pos = 0 if pos > 4 else pos  # past dWin: the next call
            part = PMIXER_BWD_ORDER[pos]
            pos += 1
        elif "ssd_gate" in name:
            part, pos = "gate", 1
        elif "memset" in name.lower():
            part = "memsets"
        elif "sum_splits" in name:
            part = "split-K sums"
        elif "ssd_" in name or "conv_" in name or "dsilu" in name:
            part, pos = "K13's span", 3
        else:
            part = "torch ops"
        ms[part] = ms.get(part, 0.0) + e.time_range.elapsed_us() / 1e3
        seen[part] = seen.get(part, 0) + 1
    parts = {p: v / (seen[p] if p in PMIXER_BWD_ORDER else iters) for p, v in ms.items()}
    print_parts(label, parts)
    rows, e = cfg["batch"] * cfg["seqlen"], cfg["embed"]
    di = cfg["nheads"] * cfg["hdim"]
    zx = 2 * di + 2 * cfg["ngroups"] * cfg["d_state"]
    sizes = {"in_proj recompute": rows * zx * e, "dWout": e * di * rows, "dgated": rows * di * e,
             "dhidden": rows * e * zx, "dWin": zx * e * rows}
    print(f"{label}: TFLOP/s " + ", ".join(f"{p} {2 * f / parts[p] / 1e9:.1f}"
                                          for p, f in sizes.items() if parts.get(p)))


def mixer_bwd_split(label, kw):
    """K13's launches summed into the parts of its span."""
    parts = {}
    for name, ms in kernel_ms_by_name(lambda: k13.ssd_mixer_bwd(**kw), iters=5)[1].items():
        part = next((p for frag, p in K13_PARTS if frag in name), "torch ops and memsets")
        parts[part] = parts.get(part, 0.0) + ms
    print_parts(label, parts)


def block_bwd_inputs(cfg, device, dtype, seed=7):
    """K7 operands at the shapes a Block gives it: K4's checkpoints of a
    forward with nonzero h0 and conv_state, and every cotangent nonzero."""
    kw = block_inputs(cfg, device, dtype, seed)
    *_, ckpt = k4.block_fused(**kw, checkpoints=True)
    g = torch.Generator().manual_seed(seed + 1)
    b, L, e = kw["hidden"].shape
    names = ("norm_w", "norm_b", "in_proj_w", "out_proj_w", "conv_w", "conv_b", "x_proj_w",
             "dt_proj_w", "dt_bias", "A", "D", "conv_state")
    return dict(res_out=kw["hidden"].float() + kw["residual"].float(),
                **{k: kw[k] for k in names}, ckpt=ckpt,
                g_out=randn((b, L, e), g, device).to(dtype),
                g_res=randn((b, L, e), g, device, 0.3),
                g_hlast=randn(tuple(kw["h0"].shape), g, device, 0.3))


def phase_block_bwd_kernels(device):
    """K4's checkpoints and K7 against their plain versions: Base bf16 and
    fp32, Small fp32 (the fp32 whole-block geometry), Base bf16 at B=4; each
    twice bit-identical, and each of K7's launches' device time a call.
    Returns the kernels-line entry of Base bf16."""
    result = None
    for cfg, label, dtype, tol in ((BASE, "bf16 Base", torch.bfloat16, BF16_GRAD_TOL),
                                   (BASE, "fp32 Base", torch.float32, GRAD_TOL),
                                   (SMALL, "fp32 Small", torch.float32, GRAD_TOL),
                                   (dict(BASE, batch=4), "bf16 Base B=4", torch.bfloat16,
                                    BF16_GRAD_TOL)):
        kw = block_inputs(cfg, device, dtype, seed=7)
        *_, ckpt = k4.block_fused(**kw, checkpoints=True)
        *_, pckpt = k4.block_fused_plain(**kw, checkpoints=True)
        check_close(f"K4 {label} checkpoints", ckpt, pckpt,
                    KERNEL_TOL if dtype == torch.float32 else BF16_TOL)
        bkw = block_bwd_inputs(cfg, device, dtype)
        res = time_against_plain(f"block_bwd {label}", k7.block_bwd, k7.block_bwd_plain, bkw, tol,
                                 block_flops(cfg, dtype, backward=True), iters=10,
                                 plain_iters=1, repeat_identical=True)
        chunk = k1.walk_bwd_chunk(cfg["batch"], cfg["seqlen"], cfg["d_inner"])
        launch_split(f"block_bwd {label} (chunk {chunk})", k7.block_bwd, bkw, top=24)
        result = result or res
        del kw, bkw
    return result


def phase_conv_kernels(device):
    """K10 against its plain version at the Base conv shapes, (1, 1569,
    1536) and (4, 1569, 1536), W = 4, fp32 and bf16. Returns the
    kernels-line entry of fp32 B=1."""
    result = None
    for bsz in (1, 4):
        for dtype, tol in ((torch.float32, KERNEL_TOL), (torch.bfloat16, BF16_TOL)):
            g = torch.Generator().manual_seed(13 + bsz)
            di, L, w = BASE["d_inner"], BASE["seqlen"], BASE["width"]
            kw = dict(x=randn((bsz, L, di), g, device).to(dtype),
                      weight=randn((w, di), g, device, 0.5),
                      bias=randn((di,), g, device, 0.1),
                      conv_state=randn((bsz, di, w), g, device).to(dtype))
            label = "fp32" if dtype == torch.float32 else "bf16"
            res = time_against_plain(
                f"causal_conv {label} B={bsz}", lambda **a: (k10.causal_conv(**a),),
                lambda **a: (k10.causal_conv_plain(**a),), kw, tol,
                {"fp32": (2 * w + 5) * bsz * L * di}, iters=50, repeat_identical=True)
            launch_split(f"causal_conv {label} B={bsz}", k10.causal_conv, kw,
                         bound_ms=res["bound_ms"], iters=50)
            if result is None:
                res["library_ms"] = conv_library_ms(kw)
                result = res
    return result


def conv_library_ms(kw):
    """K10 without its SiLU and with a zero window against the one PyTorch
    call that computes that function, ``F.conv1d(..., groups=D)`` on the
    channels-first copy of x (left-padded by W - 1; its first L outputs):
    outputs compared (1e-5), then both timed. Returns the call's ms."""
    F = torch.nn.functional
    x, w, b = kw["x"], kw["weight"], kw["bias"]
    width, d = w.shape
    zero = dict(kw, conv_state=torch.zeros_like(kw["conv_state"]), activation=None)
    xt = x.transpose(1, 2).contiguous()
    wt = w.t().contiguous().unsqueeze(1)
    lib = lambda: F.conv1d(xt, wt, b, padding=width - 1, groups=d)  # noqa: E731
    got = k10.causal_conv(**zero)
    want = lib()[..., :x.shape[1]].transpose(1, 2)
    check_close("causal_conv no SiLU, zero window vs F.conv1d", got, want, KERNEL_TOL)
    ms, lib_ms = event_ms(lambda: k10.causal_conv(**zero), 50), event_ms(lib, 50)
    print(f"kernel causal_conv no SiLU, zero window: {ms:.4f} ms; F.conv1d(groups={d}) "
          f"{lib_ms:.4f} ms")
    return lib_ms


def phase_conv_path(device):
    """K10's route, ``causal_conv1d(use_kernel=True)`` (the JAX package's
    ``use_pallas=True``), forward and backward at (4, 1569, 1536): y and
    the new window against the plain composition, gradients (autograd of
    the plain composition behind the kernel) within 1e-5."""
    g = torch.Generator().manual_seed(17)
    di, L, w = BASE["d_inner"], BASE["seqlen"], BASE["width"]
    leaves = [randn((4, L, di), g, device), randn((w, di), g, device, 0.5),
              randn((di,), g, device, 0.1)]
    state = randn((4, di, w), g, device)
    outs = []
    for use_kernel in (True, False):
        args = [t.detach().clone().requires_grad_() for t in leaves]
        before = launches()
        y, window = causal_conv1d(*args, initial_state=state, return_final_state=True,
                                  use_kernel=use_kernel)
        y.square().mean().backward()
        torch.cuda.synchronize()
        outs.append((y.detach(), window, [a.grad for a in args]))
        if use_kernel:
            used = delta(launches(), before)
            expect_launches("conv path", used, causal_conv=1)
    check_close("conv path y vs plain composition", outs[0][0], outs[1][0], KERNEL_TOL)
    check(torch.equal(outs[0][1], outs[1][1]), "conv path: new window differs")
    for name, a, b in zip(("dx", "dweight", "dbias"), outs[0][2], outs[1][2]):
        check_close(f"conv path {name} vs plain composition", a, b, KERNEL_TOL)
    return used


def phase_eval_backward(device, sd0, clip, depth):
    """The bf16 Base model in eval mode with a loss on x_vis and x_pool
    (noise targets): every parameter gets a gradient, through K4 forward
    and K7 backward, within 5e-2 of the same model on plain versions; then
    the same backward under VIDEOMAMBA_BLOCK_BWD=composite (K1 and K5 in
    the recompute, no K7) against the K7 gradients. Returns the launches of
    both runs."""
    model = cast_module_for_compute(base_model(device, sd0), torch.bfloat16).eval()
    clip = clip.clone()  # made under inference_mode, which autograd cannot save
    g = torch.Generator().manual_seed(9)
    target = randn((1, clip.shape[2] * model.patch_embed.num_patches, model.embed_dim),
                   g, device)
    # Noise targets for both outputs: the mean square of the pool norm's
    # output alone is constant (a LayerNorm with unit weight and zero bias),
    # so its gradient would be rounding noise.
    pool_target = randn((1, 1, model.embed_dim), g, device)

    def backward():
        model.zero_grad(set_to_none=True)
        x_vis, x_pool = model(clip)
        loss = ((x_vis.float() - target).square().mean()
                + (x_pool.float() - pool_target).square().mean())
        loss.backward()
        torch.cuda.synchronize()
        return grads_of(model)

    before = launches()
    grads = backward()
    used = delta(launches(), before)
    expect_launches("bf16 eval backward", used, block_fused=depth, block_bwd=depth,
                    fused_add_norm=1, mixer_fused=0, mixer_bwd=0, selective_scan_bwd=0)
    missing = [name for name, p in model.named_parameters() if p.grad is None]
    check(not missing, f"bf16 eval backward: no gradient for {missing}")
    print(f"bf16 eval backward: all {len(grads)} parameters have gradients")
    with plain_versions():
        before = launches()
        want = backward()
        check(launches() == before, "bf16 eval plain-version backward launched a kernel")
    compare_grads("bf16 eval backward vs plain versions", grads, want, BF16_STEP_TOL)
    os.environ["VIDEOMAMBA_BLOCK_BWD"] = "composite"
    try:
        before = launches()
        composite = backward()
        used_c = delta(launches(), before)
    finally:
        del os.environ["VIDEOMAMBA_BLOCK_BWD"]
    expect_launches("bf16 eval backward, composite", used_c, block_fused=depth,
                    block_bwd=0, selective_scan=depth, selective_scan_bwd=depth)
    compare_grads("composite block backward vs K7", composite, grads, BF16_STEP_TOL)
    return {k: used[k] + used_c[k] for k in used}


def phase_train_block_route(device, sd0, batch2, batch4, depth):
    """The bench recipe (bf16 over fp32 masters) at B=2 under
    VIDEOMAMBA_BLOCK_BWD=fused: every Block on the whole-block route (K4
    with checkpoints, K7), against the same model on plain versions; then
    steps at B=4, timed. Returns (launches of the B=2 step, ms, peak GiB)."""
    os.environ["VIDEOMAMBA_BLOCK_BWD"] = "fused"
    try:
        model = base_model(device, sd0)
        step = make_train_step(model, adamw(model), compute_dtype=torch.bfloat16)
        before = launches()
        metrics = step(batch2, torch.Generator().manual_seed(1))
        torch.cuda.synchronize()
        used = delta(launches(), before)
        expect_launches("bf16 train step, whole-block route", used, block_fused=depth,
                        block_bwd=depth, mixer_fused=0, mixer_bwd=0, fused_add_norm=1)
        grads = grads_of(model)
        load_state_dict(model, sd0)
        with plain_versions():
            before = launches()
            plain_metrics = step(batch2, torch.Generator().manual_seed(1))
            torch.cuda.synchronize()
            check(launches() == before, "whole-block plain-version step launched a kernel")
        check_close("whole-block train step loss vs plain versions",
                    metrics["loss"].reshape(1), plain_metrics["loss"].reshape(1), BF16_TOL)
        compare_grads("whole-block train step vs plain versions", grads, grads_of(model),
                      BF16_STEP_TOL)
        del plain_metrics
        step = make_train_step(model, adamw(model), compute_dtype=torch.bfloat16)
        ms, peak = timed_steps(step, batch4, "bf16 train step, whole-block route (4,3,8,224,224)")
    finally:
        del os.environ["VIDEOMAMBA_BLOCK_BWD"]
    del model, step
    torch.cuda.empty_cache()
    return used, ms, peak


def frame_tokens(model, frames, offset):
    """The encoder's input tokens of ``frames`` (no CLS) at temporal
    position ``offset``: patch embedding plus positional embeddings, as
    PretrainVideoMamba._encoder forms them."""
    dtype = model.patch_embed.proj.weight.dtype
    tok = model.patch_embed(frames.to(dtype))
    gh, gw = model._spatial_token_grid(frames.shape[-2], frames.shape[-1])
    tok = tok + model._get_spatial_pos_embedding(gh, gw, dtype)[:, None]
    tok = tok + model._get_temporal_pos_embedding(tok.shape[1], offset, dtype)[:, :, None]
    return tok.reshape(tok.shape[0], -1, model.embed_dim)


def odd_decode_inputs(m2, wdt, sdt, device, depth=2, b=3):
    """A decode stack's operands (weights in ``wdt``, conv windows and the
    Mamba-1 states in ``sdt``) at a d_model that is not a multiple of 8:
    K9 at d_model 60, d_inner 120, dt_rank 4; K15 at d_model 100, 8 heads
    of 16, d_state 16 (d_inner 128, the JAX gate's multiple)."""
    g = torch.Generator().manual_seed(31)

    def rn(*shape, scale=1.0):
        return randn(shape, g, device, scale)

    e, n, w = (100, 16, 4) if m2 else (60, 16, 4)
    common = dict(token=rn(b, e), norm_w=1 + rn(depth, e, scale=0.1), norm_b=None,
                  norm_type="rms", eps=1e-5)
    if m2:
        h, hp = 8, 16
        di = h * hp
        cd = di + 2 * n
        return dict(common, in_proj_w=rn(depth, di + cd + h, e, scale=e ** -0.5).to(wdt),
                    out_proj_w=rn(depth, e, di, scale=di ** -0.5).to(wdt),
                    conv_w=rn(depth, cd, w, scale=0.5).to(wdt), conv_b=rn(depth, cd, scale=0.1),
                    A=-torch.exp(rn(depth, h, scale=0.5)), D=rn(depth, h),
                    dt_bias=torch.linspace(-4.0, -1.0, h).to(device).expand(depth, h).contiguous(),
                    gate_w=1 + rn(depth, di, scale=0.1), conv_states=rn(depth, b, cd, w).to(sdt),
                    ssm_states=rn(depth, b, h, hp, n, scale=0.3), ngroups=1, gate_eps=1e-5)
    di, r = 2 * e, 4
    return dict(common, in_proj_w=rn(depth, 2 * di, e, scale=e ** -0.5).to(wdt),
                out_proj_w=rn(depth, e, di, scale=di ** -0.5).to(wdt),
                conv_w=rn(depth, di, w, scale=0.5).to(wdt), conv_b=rn(depth, di, scale=0.1),
                x_proj_w=rn(depth, r + 2 * n, di, scale=di ** -0.5).to(wdt),
                dt_proj_w=rn(depth, di, r, scale=r ** -0.5).to(wdt),
                dt_bias=torch.linspace(-4.0, -1.0, di).to(device).expand(depth, di).contiguous(),
                A=-torch.exp(rn(depth, di, n, scale=0.3)), D=rn(depth, di),
                conv_states=rn(depth, b, di, w).to(sdt),
                ssm_states=rn(depth, b, di, n, scale=0.3).to(sdt))


def phase_decode(model, label, clip5, tol, kernel_tol, depth, wide_steps=3):
    """Prefill 4 frames with StreamingSession, adopt its state in a
    DecodeSession, decode the 5th frame's 196 tokens through the decode
    kernel (K9, or K15 for a Mamba-2 model; + K2 for the final norm) and
    hold them against the 5-frame full forward's last 196 tokens; then the
    kernel against its plain version over 8 steps from the same states (and
    over ``wide_steps`` at B=80), and the time per token at B=1, 8 and 80.
    Returns (launches of the decode, the kernels-line entry at B=1)."""
    tpf = model.patch_embed.num_patches
    full_vis, _ = model(clip5)
    stream = StreamingSession(model, batch_size=1)
    stream.process(clip5[:, :, :4])
    session = DecodeSession(model, batch_size=1)
    check(session.use_kernel, f"{label} decode: the session did not take its kernel")
    if session.is_m2:
        name, kernel, plain = "decode_stack_m2", k9.decode_stack_m2, k9.decode_stack_m2_plain
        knum = "K15"
    else:
        name, kernel, plain = "decode_stack", k9.decode_stack, k9.decode_stack_plain
        knum = "K9"
    session.load_streaming_state(stream.state)
    tokens = frame_tokens(model, clip5[:, :, 4:], offset=4)
    before = launches()
    feats = [session.step(tokens[:, i]) for i in range(tokens.shape[1])]
    torch.cuda.synchronize()
    used = delta(launches(), before)
    others = {k: 0 for k in ("decode_stack", "decode_stack_m2", "block_fused", "mixer_fused",
                             "ssd_mixer", "ssd_pmixer") if k != name}
    expect_launches(f"{label} decode", used, **{name: tpf}, fused_add_norm=tpf, **others)
    check_close(f"{label} decode ({knum}) vs full 5-frame forward, last frame",
                torch.stack(feats, dim=1), full_vis[:, -tpf:], tol)

    def against_plain(tag, kw, tok_at, steps):
        """``steps`` tokens through the kernel and its plain version from
        copies of the same states, the first token also run again from a
        copy and required bit-identical; returns the largest abs error."""
        kc, ks = kw["conv_states"].clone(), kw["ssm_states"].clone()
        pc, ps = kc.clone(), ks.clone()
        rc, rs = kc.clone(), ks.clone()
        again = [t.clone() for t in kernel(tok_at(0), **dict(kw, conv_states=rc, ssm_states=rs))]
        errs = []
        for i in range(steps):
            hk, rk, kc, ks = kernel(tok_at(i), **dict(kw, conv_states=kc, ssm_states=ks))
            if i == 0:
                check(all(torch.equal(a, b) for a, b in zip((hk, rk, kc, ks), again)),
                      f"{name} {label} {tag}: two runs on the same inputs differ")
            hp, rp, pc, ps = plain(tok_at(i), **dict(kw, conv_states=pc, ssm_states=ps))
            torch.cuda.synchronize()
            for out, a, b in (("hidden", hk, hp), ("residual", rk, rp),
                              ("conv_states", kc, pc), ("ssm_states", ks, ps)):
                errs.append(check_close(f"kernel {name} {label} {tag} step {i} {out}", a, b,
                                        kernel_tol))
        return max(errs)

    err = against_plain("B=1", dict(session.stacked, **session.kernel_kw,
                                    conv_states=session.conv_states,
                                    ssm_states=session.ssm_states),
                        lambda i: tokens[:, i % tokens.shape[1]], 8)
    entry = None
    print(f"decode {label}: {name} B=1 repeats bit-identical")
    for bsz in (9, 81):  # one past each batch-tile edge, against the plain version
        sess = DecodeSession(model, batch_size=bsz)
        tok = randn((bsz, model.embed_dim), torch.Generator().manual_seed(bsz),
                    model.norm.weight.device)
        against_plain(f"B={bsz}", dict(sess.stacked, **sess.kernel_kw,
                                       conv_states=sess.conv_states,
                                       ssm_states=sess.ssm_states),
                      lambda i: tok * (i + 1), 3)
        del sess
    # A d_model that is not a multiple of 8, which the launch pads with zero
    # lanes: 60 (d_inner 120) for K9, 100 (d_inner 128) for K15.
    odd = odd_decode_inputs(session.is_m2, session.stacked["in_proj_w"].dtype,
                            session.conv_states.dtype, model.norm.weight.device)
    tok_odd = odd.pop("token")
    against_plain(f"d_model {tok_odd.shape[1]}", odd, lambda i: tok_odd * (i + 1), 3)
    for bsz in (1, 8, 80):
        sess = DecodeSession(model, batch_size=bsz)
        check(sess.use_kernel, f"{label} decode B={bsz}: the session did not take {knum}")
        tok = randn((bsz, model.embed_dim), torch.Generator().manual_seed(bsz),
                    model.norm.weight.device)
        kwb = dict(sess.stacked, **sess.kernel_kw, conv_states=sess.conv_states,
                   ssm_states=sess.ssm_states)
        if bsz > 1:  # at full tiles, against the plain version
            against_plain(f"B={bsz}", kwb, lambda i: tok * (i + 1),
                          wide_steps if bsz > 8 else 3)
        ms = event_ms(lambda: kernel(tok, **kwb), iters=100, warmup=5)
        phases = k9.phase_ms(kernel, tok, kwb)
        plain_ms = event_ms(lambda: plain(tok, **kwb), iters=5, warmup=1)
        step_ms = host_ms(lambda: sess.step(tok), repeats=50)
        wall, dev = device_ms(lambda: sess.step(tok), iters=50,
                              label=f"decode {label} B={bsz}", top=6)
        moved = nbytes(tok, *(t for t in sess.stacked.values()), sess.conv_states,
                       sess.ssm_states) + nbytes(sess.conv_states, sess.ssm_states) \
            + 2 * 4 * bsz * model.embed_dim
        w_el = sum(sess.stacked[k].numel()
                   for k in ("in_proj_w", "out_proj_w", "x_proj_w", "dt_proj_w")
                   if k in sess.stacked)
        kind = "bf16" if sess.stacked["in_proj_w"].dtype == torch.bfloat16 else "fp32"
        mx = model.layers[0].mixer
        ops = {kind: 2 * bsz * w_el}
        ops["fp32"] = ops.get("fp32", 0) + 6 * bsz * depth * mx.d_inner * (mx.d_state
                                                                           + mx.d_conv)
        b = bound(moved, ops)
        idle = "not measured" if dev is None else f"{100 * (wall - dev) / wall:.1f} %"
        dev_txt = "not measured" if dev is None else f"{dev:.4f} ms"
        print(f"decode {label} B={bsz}: {knum} {ms:.4f} ms a token (event), plain "
              f"{plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}, "
              f"{moved / 1e6:.1f} MB); session step {step_ms:.4f} ms host, profiled "
              f"{wall:.4f} ms wall, device kernels {dev_txt}, idle {idle}; "
              f"{k9.LAUNCHES_PER_TOKEN} launch of {len(phases)} x {depth} phases "
              f"({len(phases) * depth - 1} grid barriers) + 1 K2 a token; phases, device ms "
              "a token: " + ", ".join(f"{k} {v:.4f}" for k, v in phases.items()))
        if bsz == 1:
            entry = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b,
                     "library_ms": None}
        del sess
    return used, entry


BASE_M2 = dict(batch=1, seqlen=1569, embed=768, nheads=24, hdim=64, ngroups=1, d_state=64,
               chunk=128, width=4)


def ssd_inputs(cfg, device, dtype, seed=13):
    """K12 and K14 operands at the shapes a Mamba2 layer gives them (nonzero
    h0 and conv window): activations and the weights a bf16 model casts in
    ``dtype``; A, D, the norm weight and the states fp32."""
    g = torch.Generator().manual_seed(seed)
    b, L, e = cfg["batch"], cfg["seqlen"], cfg["embed"]
    h, p, gr, n, w = cfg["nheads"], cfg["hdim"], cfg["ngroups"], cfg["d_state"], cfg["width"]
    di = h * p
    cd = di + 2 * gr * n
    common = dict(
        A=-torch.exp(randn((h,), g, device, 0.5)), conv_weight=randn((cd, w), g, device, 0.5).to(dtype),
        conv_bias=randn((cd,), g, device, 0.2).to(dtype), D=randn((h,), g, device),
        dt_bias=torch.linspace(-6.9, -2.3, h).to(device).to(dtype),
        initial_state=randn((b, h, p, n), g, device, 0.3), conv_state=randn((b, cd, w), g, device),
        norm_weight=1 + randn((di,), g, device, 0.1), norm_eps=1e-5, chunk_size=cfg["chunk"],
        nheads=h, hdim=p, ngroups=gr, d_state=n)
    mixer = dict(common, zxbcdt=randn((b, L, di + cd + h), g, device).to(dtype))
    pmixer = dict(common, hidden=randn((b, L, e), g, device).to(dtype),
                  in_proj_w=randn((di + cd + h, e), g, device, e ** -0.5).to(dtype),
                  out_proj_w=randn((e, di), g, device, di ** -0.5).to(dtype))
    return mixer, pmixer


def ssd_flops(cfg, dtype, projected):
    """K12's operations (K14's with ``projected``): the conv; per row the
    causal half of C B^T and of m x (Q / 2 keys on average); the inter-chunk
    readout and the chunk states (2 P N a head each); D skip, gate and
    norm; K14 adds in_proj (all its columns) and out_proj."""
    b, L, e = cfg["batch"], cfg["seqlen"], cfg["embed"]
    h, p, gr, n, w, q = (cfg["nheads"], cfg["hdim"], cfg["ngroups"], cfg["d_state"],
                         cfg["width"], cfg["chunk"])
    di = h * p
    cd = di + 2 * gr * n
    kind = "bf16" if dtype == torch.bfloat16 else "fp32"
    products = b * L * (q * (gr * n + h * p) + 4 * h * p * n)
    if projected:
        products += 2 * b * L * e * (di + cd + h + di)
    return {kind: products, "fp32": (products if kind == "fp32" else 0)
            + b * L * (2 * w * cd + 12 * di)}


def phase_ssd_kernels(device):
    """K12 and K14 against their plain versions at Base m2 shapes, fp32 and
    bf16, K12 with two groups at a small width, and both at upstream
    Mamba-2's chunk 256 and d_state 128; each timed beside its plain
    version. Returns the kernels-line entries (fp32 Base)."""
    entries = {}
    for dtype, tol in ((torch.float32, KERNEL_TOL), (torch.bfloat16, BF16_TOL)):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        mixer, pmixer = ssd_inputs(BASE_M2, device, dtype)
        for name, fn, plain, kw, projected in (
                ("ssd_mixer", k12.ssd_mixer, k12.ssd_mixer_plain, mixer, False),
                ("ssd_pmixer", k14.ssd_pmixer, k14.ssd_pmixer_plain, pmixer, True)):
            result = time_against_plain(f"{name} {tag} Base m2", fn, plain, kw, tol,
                                        ssd_flops(BASE_M2, dtype, projected))
            if dtype == torch.float32:
                entries[name] = result
        pmixer_split(f"ssd_pmixer {tag} Base m2 by launch", pmixer)
    matmul_yardstick(BASE_M2, device)
    small = dict(BASE_M2, embed=256, nheads=8, ngroups=2)
    time_against_plain("ssd_mixer fp32 two groups (Di 512)", k12.ssd_mixer,
                       k12.ssd_mixer_plain, ssd_inputs(small, device, torch.float32)[0],
                       KERNEL_TOL, ssd_flops(small, torch.float32, False))
    for label, cfg in (("chunk 256", dict(BASE_M2, chunk=256)),
                       ("d_state 128", dict(BASE_M2, d_state=128))):
        for dtype, tol in ((torch.float32, KERNEL_TOL), (torch.bfloat16, BF16_TOL)):
            tag = "fp32" if dtype == torch.float32 else "bf16"
            mixer, pmixer = ssd_inputs(cfg, device, dtype)
            for name, fn, plain, kw, projected in (
                    ("ssd_mixer", k12.ssd_mixer, k12.ssd_mixer_plain, mixer, False),
                    ("ssd_pmixer", k14.ssd_pmixer, k14.ssd_pmixer_plain, pmixer, True)):
                time_against_plain(f"{name} {tag} Base m2, {label}", fn, plain, kw, tol,
                                   ssd_flops(cfg, dtype, projected), iters=5)
    return entries


def build_m2_models(device):
    """VideoMamba-Base-m2 fp32 with kernels on, and the same weights with the
    plain add-norm (its forwards run under VIDEOMAMBA_SSD_METHOD=chunked:
    the plain chunked SSD, an independent algorithm)."""
    g = torch.Generator().manual_seed(0)
    fast = videomamba_base_m2(pool_type="avg", device=device, generator=g).eval()
    plain = videomamba_base_m2(pool_type="avg", device=device, fused_add_norm=False).eval()
    load_state_dict(plain, fast.state_dict())
    return fast, plain


@contextlib.contextmanager
def env(**values):
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_m2_forward(fast, plain, clip, depth):
    """The Base m2 fp32 full clip: K2 25, K14 24, K12 0 launches; against the
    plain chunked path; then the same forward under VIDEOMAMBA_SSD_PMIXER=0:
    K12 24, K14 0, against the K14 forward."""
    before = launches()
    x_vis, x_pool = fast(clip)
    torch.cuda.synchronize()
    expect_launches("m2 forward", delta(launches(), before), fused_add_norm=depth + 1,
                    ssd_pmixer=depth, ssd_mixer=0, mixer_fused=0, block_fused=0)
    tokens = clip.shape[2] // fast.patch_embed.tubelet_size * fast.patch_embed.num_patches
    check(x_vis.shape == (clip.shape[0], tokens, fast.embed_dim),
          f"m2 x_vis shape {tuple(x_vis.shape)}")
    with env(VIDEOMAMBA_SSD_METHOD="chunked"):
        p_vis, p_pool = plain(clip)
    check_close("m2 forward x_vis vs plain chunked path", x_vis, p_vis, MODEL_TOL)
    check_close("m2 forward x_pool vs plain chunked path", x_pool, p_pool, MODEL_TOL)
    with env(VIDEOMAMBA_SSD_PMIXER="0"):
        before = launches()
        k12_vis, _ = fast(clip)
        torch.cuda.synchronize()
        expect_launches("m2 forward, VIDEOMAMBA_SSD_PMIXER=0", delta(launches(), before),
                        fused_add_norm=depth + 1, ssd_mixer=depth, ssd_pmixer=0)
    check_close("m2 forward K12 route vs K14 route", k12_vis, x_vis, MODEL_TOL)
    return x_vis


def phase_m2_bf16_forward(model, clip, fp32_vis, depth):
    """The Base m2 weights cast for bf16 serving: K2 25, K14 24; against the
    same model with every kernel swapped for its plain version (2e-2); the
    max and mean relative error against the fp32 features printed."""
    before = launches()
    x_vis, x_pool = model(clip)
    torch.cuda.synchronize()
    expect_launches("m2 bf16 forward", delta(launches(), before), fused_add_norm=depth + 1,
                    ssd_pmixer=depth, ssd_mixer=0)
    check(x_vis.dtype == torch.bfloat16, f"m2 bf16 x_vis is {x_vis.dtype}")
    check(bool(torch.isfinite(x_pool).all()), "m2 bf16 forward: non-finite x_pool")
    with plain_versions():
        ref, _ = model(clip)
    check_close("m2 bf16 forward x_vis vs plain versions", x_vis, ref, BF16_MODEL_TOL)
    diff = (x_vis.double() - fp32_vis.double()).abs()
    print(f"m2 bf16 vs fp32 x_vis: max rel {float(diff.max() / fp32_vis.abs().max()):.3e}, "
          f"mean rel {float(diff.mean() / fp32_vis.double().abs().mean()):.3e}")
    return x_vis


def serving_times(label, model, clip, plain_model=None, plain_env=None):
    """Host ms of the full clip (median of 5) and of a first and a
    continuation 4-frame chunk (medians over 5 sessions)."""
    fwd_ms = host_ms(lambda: model(clip), repeats=5)
    chunk0, chunk1 = [], []
    for _ in range(5):
        session = StreamingSession(model, batch_size=1)
        chunk0.append(host_ms(lambda: session.process(clip[:, :, :4]), repeats=1))
        chunk1.append(host_ms(lambda: session.process(clip[:, :, 4:]), repeats=1))
    plain_note = ""
    if plain_model is not None:
        with env(**(plain_env or {})):
            plain_note = f"; plain path {host_ms(lambda: plain_model(clip), repeats=1):.3f} ms"
    times = (fwd_ms, statistics.median(chunk0), statistics.median(chunk1))
    print(f"{label} full-clip forward (1,3,8,224,224): {fwd_ms:.3f} ms{plain_note}")
    print(f"{label} streaming chunk (4 frames): first {times[1]:.3f} ms, "
          f"continuation {times[2]:.3f} ms")
    return times


def serving_profile(label, model, clip):
    """The full clip's and a first chunk's device kernel time, idle share
    and top kernels under torch.profiler. Run after the host timings, which
    a profiler session before them can slow where the host, not the device,
    sets the time."""
    for what, fn in (("full clip", lambda: model(clip)),
                     ("first chunk", lambda: StreamingSession(model, batch_size=1).process(
                         clip[:, :, :4]))):
        wall, dev = device_ms(fn, iters=3, label=f"{label} {what}", top=8)
        idle = "not measured" if dev is None else f"{100 * (wall - dev) / wall:.1f} %"
        dev_txt = "not measured" if dev is None else f"{dev:.3f} ms"
        print(f"{label} {what} under the profiler: {wall:.3f} ms wall, device kernels "
              f"{dev_txt}, idle {idle}")


def ssd_bwd_flops(cfg, dtype, kind, ffma=False):
    """The least operations of K11's backward ("scan"), K13 ("mixer") or
    K14's backward ("pmixer"): per row the causal half of C B^T, dM, M^T dy
    and the two dcb products (Q / 2 keys on average), and per row and head
    the four (P, N) state products; K13 adds the conv backward and the
    epilogue, K14 the five projection products, which at fp32 run as three
    TF32 products each ("tf32", or on FMA with ``ffma``)."""
    b, L, e = cfg["batch"], cfg["seqlen"], cfg["embed"]
    h, p, gr, n, w, q = (cfg["nheads"], cfg["hdim"], cfg["ngroups"], cfg["d_state"],
                         cfg["width"], cfg["chunk"])
    di = h * p
    cd = di + 2 * gr * n
    tag = "bf16" if dtype == torch.bfloat16 else "fp32"
    products = 2 * b * L * ((q // 2) * (gr * n + 2 * h * (p + n)) + 4 * h * p * n)
    fp32 = 0
    if kind != "scan":
        fp32 = b * L * (4 * w * cd + 20 * di)
    proj = 2 * b * L * e * (3 * (di + cd) + 2 * di) if kind == "pmixer" else 0
    if tag == "fp32" and not ffma:
        return {"fp32": products + fp32, "tf32": 3 * proj}
    products += proj
    return {tag: products, "fp32": (products if tag == "fp32" else 0) + fp32}


def ssd_train_checks(cfg, device, dtype, label, iters, split=False):
    """K12 with checkpoints, K11 forward and backward, K13 and K14's
    backward against their plain versions on one set of Base-m2-shaped
    inputs (fp32 2e-5, bf16 2e-2), each timed beside its plain version;
    the backward kernels twice bit-identical; with ``split``, K13's parts.
    Returns the kernels-line entries."""
    tol = GRAD_TOL if dtype == torch.float32 else BF16_GRAD_TOL
    tag = f"{'fp32' if dtype == torch.float32 else 'bf16'} {label}"
    mixer, pmixer = ssd_inputs(cfg, device, dtype)
    g = torch.Generator().manual_seed(29)
    b, L, e = cfg["batch"], cfg["seqlen"], cfg["embed"]
    h, p, gr, n, q = cfg["nheads"], cfg["hdim"], cfg["ngroups"], cfg["d_state"], cfg["chunk"]
    di, gn = h * p, gr * n
    shape = dict(chunk_size=q, nheads=h, hdim=p, ngroups=gr, d_state=n)
    dev = device
    zx = mixer["zxbcdt"]
    core = dict(zx=zx, dt_p=_prepare_dt(zx[..., 2 * di + 2 * gn:], mixer["dt_bias"], True),
                A=mixer["A"], conv_weight=mixer["conv_weight"], conv_bias=mixer["conv_bias"],
                D=mixer["D"], initial_state=mixer["initial_state"],
                conv_state=mixer["conv_state"], norm_weight=mixer["norm_weight"],
                norm_eps=1e-5, **shape)
    out = {}
    out["ssd_mixer"] = time_against_plain(
        f"ssd_mixer checkpoints {tag}", lambda **kw: k12.ssd_mixer_core(**kw, checkpoints=True),
        lambda **kw: k12.ssd_core_plain(*kw.values(), checkpoints=True), core, tol,
        ssd_flops(cfg, dtype, False), iters=iters)
    *_, hins, yd = k12.ssd_mixer_core(**core, checkpoints=True)
    scan = dict(x4=zx[..., di:2 * di].reshape(b, L, h, p), dt_p=core["dt_p"], A=core["A"],
                B4=zx[..., 2 * di:2 * di + gn].reshape(b, L, gr, n),
                C4=zx[..., 2 * di + gn:2 * di + 2 * gn].reshape(b, L, gr, n),
                h0=core["initial_state"], chunk_size=q)
    out["ssd_scan"] = time_against_plain(
        f"ssd_scan {tag}", lambda **kw: k11.ssd_scan(**kw, checkpoints=True),
        lambda **kw: k11.ssd_scan_plain(**kw, checkpoints=True), scan, tol,
        {"fp32" if dtype == torch.float32 else "bf16":
         b * L * (q * (gn + di) + 4 * di * n)}, iters=iters)
    scan_bwd = dict(scan, hins=k11.ssd_scan(**scan, checkpoints=True)[2],
                    dy=randn((b, L, h, p), g, dev), dhlast=randn((b, h, p, n), g, dev, 0.5))
    del scan_bwd["h0"]
    out["ssd_scan_bwd"] = time_against_plain(
        f"ssd_scan_bwd {tag}", k11.ssd_scan_bwd, k11.ssd_scan_bwd_plain, scan_bwd, tol,
        ssd_bwd_flops(cfg, dtype, "scan"), iters=iters, repeat_identical=True)
    mixer_bwd = dict(core, hins=hins, yd=yd, dout=randn((b, L, di), g, dev).to(dtype),
                     dhlast=scan_bwd["dhlast"])
    del mixer_bwd["initial_state"]
    out["ssd_mixer_bwd"] = time_against_plain(
        f"ssd_mixer_bwd {tag}", k13.ssd_mixer_bwd, k13.ssd_mixer_bwd_plain, mixer_bwd, tol,
        ssd_bwd_flops(cfg, dtype, "mixer"), iters=iters, repeat_identical=True)
    if split:
        mixer_bwd_split(f"ssd_mixer_bwd {tag} by part", mixer_bwd)
    dt_p = k14.dt_projection(pmixer["hidden"], pmixer["in_proj_w"], h, pmixer["dt_bias"])
    pw = {k: pmixer[k] for k in ("A", "in_proj_w", "out_proj_w", "conv_weight", "conv_bias",
                                 "D")}
    *_, hins2, yd2 = k14.ssd_pmixer_core(
        pmixer["hidden"], dt_p, *pw.values(), pmixer["initial_state"], pmixer["conv_state"],
        pmixer["norm_weight"], 1e-5, q, h, p, gr, n, checkpoints=True)
    pmixer_bwd = dict(hidden=pmixer["hidden"], dt_p=dt_p, **pw,
                      conv_state=pmixer["conv_state"], norm_weight=pmixer["norm_weight"],
                      norm_eps=1e-5, hins=hins2, yd=yd2,
                      dout=randn((b, L, e), g, dev).to(dtype), dhlast=scan_bwd["dhlast"],
                      **shape)
    out["ssd_pmixer_bwd"] = time_against_plain(
        f"ssd_pmixer_bwd {tag}", k14.ssd_pmixer_bwd, k14.ssd_pmixer_bwd_plain, pmixer_bwd,
        tol, ssd_bwd_flops(cfg, dtype, "pmixer"), iters=iters, repeat_identical=True)
    if dtype == torch.float32:
        ffma = bound(0, ssd_bwd_flops(cfg, dtype, "pmixer", ffma=True))["bound_ms"]
        print(f"ssd_pmixer_bwd {tag}: bound {out['ssd_pmixer_bwd']['bound_ms']:.4f} ms with "
              f"its products as three TF32 products, {ffma:.4f} ms on FMA")
    if split:
        pmixer_bwd_split(f"ssd_pmixer_bwd {tag} by part", pmixer_bwd, cfg)
    return out


# K14's backward product tile alone: (layout, M, N, K) at Base-m2 widths.
PRODUCT_SHAPES = (("nt", 3200, 768), ("nn", 1536, 768), ("nn", 768, 3200), ("tn", 768, 1536),
                  ("tn", 3200, 768))


def product_operands(layout, m, n, k, dtype, g, device, pad=0):
    """a, b of a projection product (rows padded by ``pad`` elements: a
    row stride TMA cannot describe when odd) and its float64 value."""
    sa = (k, m) if layout == "tn" else (m, k)
    sb = (n, k) if layout == "nt" else (k, n)
    a = randn((sa[0], sa[1] + pad), g, device).to(dtype)[:, :sa[1]]
    b = randn((sb[0], sb[1] + pad), g, device).to(dtype)[:, :sb[1]]
    x = a.double().t() if layout == "tn" else a.double()
    y = b.double().t() if layout == "nt" else b.double()
    return a, b, x @ y


def phase_projection_products(device):
    """K14's backward product tile alone at each layout and dtype, at B L =
    1, 1569 and 6276 rows (the rows of M for NT and NN, the contraction of
    TN) and at an odd row stride (the staging variant), against a float64
    product (fp32 2e-5, bf16 2e-2), twice bit-identical."""
    g = torch.Generator().manual_seed(41)
    for dtype in (torch.float32, torch.bfloat16):
        tol = GRAD_TOL if dtype == torch.float32 else BF16_GRAD_TOL
        tag = "fp32" if dtype == torch.float32 else "bf16"
        cases = [(layout, rows, x, y, 0) for rows in (1, 1569, 6276)
                 for layout, x, y in PRODUCT_SHAPES]
        cases += [(layout, 1569, x, y, 1) for layout, x, y in PRODUCT_SHAPES[:4]]
        for layout, rows, x, y, pad in cases:
            m, n, k = (x, y, rows) if layout == "tn" else (rows, x, y)
            a, b, want = product_operands(layout, m, n, k, dtype, g, device, pad)
            got = k14.projection_product(layout, a, b)
            again = k14.projection_product(layout, a, b)
            torch.cuda.synchronize()
            label = (f"projection_product {layout} {tag} M {m} N {n} K {k}"
                     + (" (odd row stride: staging)" if pad else ""))
            check(torch.equal(got, again), f"{label}: two runs differ")
            check_close(label, got, want, tol)
            del a, b, want, got, again
    torch.cuda.empty_cache()


def phase_ssd_train_kernels(device):
    """K14's backward product tile alone (phase_projection_products), then
    the Mamba-2 training kernels at Base-m2 shapes, B = 1 and 4, fp32 and
    bf16 (ssd_train_checks), then at head dim 256 and d_state 256 (fp32).
    Returns the kernels-line entries of fp32 B = 1."""
    phase_projection_products(device)
    entries = {}
    for batch in (1, 4):
        for dtype in (torch.float32, torch.bfloat16):
            res = ssd_train_checks(dict(BASE_M2, batch=batch), device, dtype,
                                   f"Base m2 B={batch}", iters=10 if batch == 1 else 3,
                                   split=True)
            if batch == 1 and dtype == torch.float32:
                entries = {k: v for k, v in res.items() if k != "ssd_mixer"}
    for label, cfg in (("head dim 256", dict(BASE_M2, nheads=6, hdim=256)),
                       ("d_state 256", dict(BASE_M2, d_state=256))):
        ssd_train_checks(cfg, device, torch.float32, label, iters=2)
    return entries


def m2_model(device, sd=None, **overrides):
    model = videomamba_base_m2(pool_type="avg", device=device,
                               generator=torch.Generator().manual_seed(0), **overrides)
    if sd is not None:
        load_state_dict(model, sd)
    return model


@contextlib.contextmanager
def all_plain():
    """Every kernel wrapper takes its plain version (the kernels' rounding
    points, no kernel), on card tensors too: the reference of the m2
    training checks."""
    saved = dispatch.runs_plain
    dispatch.runs_plain = lambda t: True
    try:
        yield
    finally:
        dispatch.runs_plain = saved


def phase_m2_train(device, depth):
    """``make_train_step`` on ``videomamba_base_m2``, the bench recipe: at
    fp32 and bf16 one B=2 step on the mixer route (K2 25, K12 24, K13 24)
    against the same model on plain versions (loss 1e-5 / 1e-2, gradients
    1e-4 / 5e-2), then the B=4 zero-target step times and peak memory; at
    fp32 one step each on VIDEOMAMBA_SSD_TRAIN_ROUTE=pmixer (K14 24, its
    backward 24) and VIDEOMAMBA_SSD_BWD=composite (K12 24, K11's backward
    24) against the mixer route (1e-4), at bf16 one pmixer-route step
    against the same step on plain versions (5e-2), and remat with drop
    path against no remat (1e-6). Returns the step times and peaks."""
    batch2 = train_batch(2, device, zero_target=False)
    batch4 = train_batch(4, device)
    sd0, times, fp32_grads = None, {}, None
    for dtype, tol, step_tol in ((None, 1e-5, STEP_GRAD_TOL),
                                 (torch.bfloat16, BF16_TOL, BF16_STEP_TOL)):
        tag = "fp32" if dtype is None else "bf16"
        model = m2_model(device, sd0)
        if sd0 is None:
            sd0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
        step = make_train_step(model, adamw(model), compute_dtype=dtype)
        before = launches()
        metrics = step(batch2, torch.Generator().manual_seed(1))
        torch.cuda.synchronize()
        expect_launches(f"m2 {tag} train step", delta(launches(), before),
                        fused_add_norm=depth + 1, ssd_mixer=depth, ssd_mixer_bwd=depth,
                        ssd_pmixer=0, ssd_pmixer_bwd=0, ssd_scan_bwd=0)
        check(all(p.dtype == torch.float32 for p in model.parameters()),
              f"m2 {tag} step: masters not fp32")
        grads = grads_of(model)
        load_state_dict(model, sd0)
        with all_plain():
            before = launches()
            plain_metrics = step(batch2, torch.Generator().manual_seed(1))
            torch.cuda.synchronize()
            check(launches() == before, f"m2 {tag} plain-version step launched a kernel")
        check_close(f"m2 {tag} train step loss vs plain versions", metrics["loss"].reshape(1),
                    plain_metrics["loss"].reshape(1), tol)
        compare_grads(f"m2 {tag} train step vs plain versions", grads, grads_of(model),
                      step_tol)
        if dtype is None:
            fp32_grads = grads
        else:
            worst = max(rel_err(grads[k], fp32_grads[k]) for k in fp32_grads)
            print(f"m2 bf16 vs fp32 train-step gradients: max rel {worst:.3e}")
        load_state_dict(model, sd0)
        before = launches()
        times[tag] = timed_steps(step, batch4, f"m2 {tag} train step (4,3,8,224,224)")
        expect_launches(f"m2 {tag} B=4 steps", delta(launches(), before),
                        ssd_mixer=7 * depth, ssd_mixer_bwd=7 * depth, ssd_pmixer=0)
        del model, step
        torch.cuda.empty_cache()

    model = m2_model(device, sd0)
    step = make_train_step(model, adamw(model))
    for route_env, want in (({"VIDEOMAMBA_SSD_TRAIN_ROUTE": "pmixer"},
                             dict(ssd_pmixer=depth, ssd_pmixer_bwd=depth, ssd_mixer=0,
                                  ssd_mixer_bwd=0)),
                            ({"VIDEOMAMBA_SSD_BWD": "composite"},
                             dict(ssd_mixer=depth, ssd_scan_bwd=depth, ssd_mixer_bwd=0))):
        load_state_dict(model, sd0)
        with env(**route_env):
            before = launches()
            step(batch2, torch.Generator().manual_seed(1))
            torch.cuda.synchronize()
        label = ", ".join(f"{k}={v}" for k, v in route_env.items())
        expect_launches(f"m2 fp32 train step, {label}", delta(launches(), before), **want)
        compare_grads(f"m2 {label} vs mixer route", grads_of(model), fp32_grads,
                      STEP_GRAD_TOL)
    del model, step
    torch.cuda.empty_cache()

    model = m2_model(device, sd0)
    step = make_train_step(model, adamw(model), compute_dtype=torch.bfloat16)
    with env(VIDEOMAMBA_SSD_TRAIN_ROUTE="pmixer"):
        before = launches()
        step(batch2, torch.Generator().manual_seed(1))
        torch.cuda.synchronize()
        expect_launches("m2 bf16 train step, VIDEOMAMBA_SSD_TRAIN_ROUTE=pmixer",
                        delta(launches(), before), ssd_pmixer=depth, ssd_pmixer_bwd=depth,
                        ssd_mixer=0, ssd_mixer_bwd=0)
        grads = grads_of(model)
        load_state_dict(model, sd0)
        with all_plain():
            step(batch2, torch.Generator().manual_seed(1))
            torch.cuda.synchronize()
    compare_grads("m2 bf16 pmixer route vs plain versions", grads, grads_of(model),
                  BF16_STEP_TOL)
    del model, step
    torch.cuda.empty_cache()

    remat_grads = []
    for use_checkpoint in (True, False):
        model = m2_model(device, sd0, drop_path_rate=0.1, use_checkpoint=use_checkpoint,
                         checkpoint_num=depth)
        make_train_step(model, adamw(model))(batch2, torch.Generator().manual_seed(7))
        remat_grads.append(grads_of(model))
        del model
    compare_grads("m2 checkpoint_num=24, drop_path 0.1 vs no remat", *remat_grads, 1e-6)
    torch.cuda.empty_cache()
    return times


def phase_ssd_chunked_path(device):
    """K11's route, ``ssd_chunked(method="pallas")`` (the JAX package's
    ``ssd_core_pallas``), forward and backward at Base-m2 shapes, B = 2, with
    D, z, dt_bias and h0: y, h_last and every gradient against
    ``method="chunked"`` (the plain chunked SSD, autograd), 1e-4."""
    g = torch.Generator().manual_seed(31)
    c = BASE_M2
    b, L, h, p, n = 2, c["seqlen"], c["nheads"], c["hdim"], c["d_state"]
    leaves = [randn((b, L, h, p), g, device), randn((b, L, h), g, device, 0.5) - 2.0,
              -torch.exp(randn((h,), g, device, 0.5)), randn((b, L, 1, n), g, device),
              randn((b, L, 1, n), g, device), randn((h,), g, device),
              randn((b, L, h, p), g, device), randn((h,), g, device, 0.1),
              randn((b, h, p, n), g, device, 0.3)]
    names = ("x", "dt", "A", "B", "C", "D", "z", "dt_bias", "initial_state")
    outs = []
    for method in ("pallas", "chunked"):
        args = [t.detach().clone().requires_grad_() for t in leaves]
        before = launches()
        y, h_last = ssd_chunked(**dict(zip(names, args)), return_last_state=True,
                                chunk_size=c["chunk"], method=method)
        (y.square().mean() + h_last.square().mean()).backward()
        torch.cuda.synchronize()
        outs.append((y.detach(), h_last.detach(), [a.grad for a in args]))
        if method == "pallas":
            used = delta(launches(), before)
            expect_launches("ssd_chunked pallas path", used, ssd_scan=1, ssd_scan_bwd=1)
    check_close("ssd_chunked pallas y vs chunked", outs[0][0], outs[1][0], MODEL_TOL)
    check_close("ssd_chunked pallas h_last vs chunked", outs[0][1], outs[1][1], MODEL_TOL)
    for name, a, b in zip(names, outs[0][2], outs[1][2]):
        check_close(f"ssd_chunked pallas d{name} vs chunked", a, b, MODEL_TOL)
    return used


def phase_state_sizes(device):
    """The Mamba-1 kernels at state sizes outside their walks' 8/16/32/64
    at Base widths (B = 1, L 1569, Di 1536): K1 and K5 at 24 (zero lanes to
    32), 128 and 256 (two slices of 128); K3 and K6, K4 and K7 (bf16) at 24
    and 128; each against its plain version (fp32 1e-5 / 2e-5, bf16 1e-2 /
    2e-2), timed over 3 calls."""
    for n in (24, 128, 256):
        cfg = dict(BASE, d_state=n)
        kw = kernel_inputs(cfg, device)
        scan = dict(kw["selective_scan"], z=kw["selective_scan"]["z"].contiguous())
        time_against_plain(f"selective_scan d_state {n}", WRAPPERS["selective_scan"],
                           k1.selective_scan_plain, dict(scan, checkpoints=True), KERNEL_TOL,
                           scan_flops(1, cfg["seqlen"], cfg["d_inner"], n), iters=3,
                           plain_iters=1)
        *_, ckpt = k1.selective_scan(**scan, checkpoints=True)
        g = torch.Generator().manual_seed(41)
        bwd = dict({k: v for k, v in scan.items() if k != "h0"}, ckpt=ckpt,
                   g_out=randn(scan["u"].shape, g, device),
                   g_hlast=randn(scan["h0"].shape, g, device, 0.3))
        time_against_plain(f"selective_scan_bwd d_state {n}", k1.selective_scan_bwd,
                           k1.selective_scan_bwd_plain, bwd, GRAD_TOL,
                           scan_flops(1, cfg["seqlen"], cfg["d_inner"], n, 26), iters=3,
                           plain_iters=1)
        if n > 128:
            continue
        mixer = kw["mixer_fused"]
        time_against_plain(f"mixer_fused d_state {n}", k3.mixer_fused, k3.mixer_fused_plain,
                           dict(mixer, checkpoints=True), KERNEL_TOL,
                           mixer_flops(1, cfg["seqlen"], cfg["d_inner"], n, cfg["dt_rank"],
                                       cfg["width"], torch.float32), iters=3, plain_iters=1)
        *_, ckpt = k3.mixer_fused(**mixer, checkpoints=True)
        g = torch.Generator().manual_seed(43)
        mbwd = dict({k: v for k, v in mixer.items() if k != "h0"}, ckpt=ckpt,
                    g_y=randn(mixer["x"].shape, g, device),
                    g_hlast=randn(mixer["h0"].shape, g, device, 0.3))
        time_against_plain(f"mixer_bwd d_state {n}", k6.mixer_bwd, k6.mixer_bwd_plain, mbwd,
                           GRAD_TOL, mixer_flops(1, cfg["seqlen"], cfg["d_inner"], n,
                                                 cfg["dt_rank"], cfg["width"], torch.float32,
                                                 backward=True), iters=3, plain_iters=1)
        blk = block_inputs(cfg, device, torch.bfloat16)
        time_against_plain(f"block_fused bf16 d_state {n}", k4.block_fused,
                           k4.block_fused_plain, dict(blk, checkpoints=True), BF16_TOL,
                           block_flops(cfg, torch.bfloat16), iters=3, plain_iters=1)
        bb = block_bwd_inputs(cfg, device, torch.bfloat16)
        time_against_plain(f"block_bwd bf16 d_state {n}", k7.block_bwd, k7.block_bwd_plain,
                           bb, BF16_GRAD_TOL, block_flops(cfg, torch.bfloat16, backward=True),
                           iters=3, plain_iters=1)


def layer_step(layer, x, plain):
    """Output and every parameter's gradient of one loss through ``layer``
    on the card, on its kernels or (``plain``) with every wrapper taking
    its plain version on card tensors."""
    layer.zero_grad()
    with all_plain() if plain else contextlib.nullcontext():
        out = layer(x)
        g = torch.Generator().manual_seed(47)
        (out * randn(out.shape, g, x.device)).sum().backward()
    torch.cuda.synchronize()
    return out.detach(), {k: p.grad.clone() for k, p in layer.named_parameters()}


def phase_repaired_gates(device):
    """Shapes the JAX package's gates take that the port's kernels once
    refused or ran past their arrays: K13 at conv width 9 (Base-m2 shapes,
    fp32, from K12's checkpoints) and K6 at width 9 (Base shapes) against
    their plain versions (2e-5), twice bit-identical; K2 and K8 at D = 3200
    (1e-5 / 2e-5); the train step of a Mamba(768, d_conv=9) layer (K3, K6)
    and of a Mamba2(768, d_conv=9) layer (K12, K13) at B = 1, L = 1569
    against the same layer on plain versions on the card (output 1e-5,
    parameter gradients 1e-4, sums over all rows of the kernels'
    outputs); ``causal_conv1d(use_kernel=True)`` at width 5 (K10).
    Returns the launches of the layer steps and the conv route."""
    cfg = dict(BASE_M2, width=9)
    mixer, _ = ssd_inputs(cfg, device, torch.float32)
    g = torch.Generator().manual_seed(45)
    b, L = cfg["batch"], cfg["seqlen"]
    h, p, n, q = cfg["nheads"], cfg["hdim"], cfg["d_state"], cfg["chunk"]
    di = h * p
    shape = dict(chunk_size=q, nheads=h, hdim=p, ngroups=cfg["ngroups"], d_state=n)
    core = dict(zx=mixer["zxbcdt"],
                dt_p=_prepare_dt(mixer["zxbcdt"][..., 2 * di + 2 * n:], mixer["dt_bias"], True),
                **{k: mixer[k] for k in ("A", "conv_weight", "conv_bias", "D", "initial_state",
                                         "conv_state", "norm_weight")}, norm_eps=1e-5, **shape)
    *_, hins, yd = k12.ssd_mixer_core(**core, checkpoints=True)
    mbwd = dict(core, hins=hins, yd=yd, dout=randn((b, L, di), g, device),
                dhlast=randn((b, h, p, n), g, device, 0.5))
    del mbwd["initial_state"]
    time_against_plain("ssd_mixer_bwd fp32 Base-m2 d_conv 9", k13.ssd_mixer_bwd,
                       k13.ssd_mixer_bwd_plain, mbwd, GRAD_TOL,
                       ssd_bwd_flops(cfg, torch.float32, "mixer"), iters=5, plain_iters=0,
                       repeat_identical=True)
    m1 = dict(BASE, width=9)
    mk = kernel_inputs(m1, device, seed=9)["mixer_fused"]
    *_, ckpt = k3.mixer_fused(**mk, checkpoints=True)
    kw = dict({k: v for k, v in mk.items() if k != "h0"}, ckpt=ckpt,
              g_y=randn(mk["x"].shape, g, device), g_hlast=randn(mk["h0"].shape, g, device, 0.3))
    time_against_plain("mixer_bwd fp32 Base d_conv 9", k6.mixer_bwd, k6.mixer_bwd_plain, kw,
                       GRAD_TOL, mixer_flops(1, L, m1["d_inner"], m1["d_state"], m1["dt_rank"],
                                             9, torch.float32, backward=True),
                       iters=5, plain_iters=0, repeat_identical=True)
    e = 3200
    nk = dict(x=randn((b, L, e), g, device), weight=1 + randn((e,), g, device, 0.1), bias=None,
              residual=randn((b, L, e), g, device), prenorm=True, residual_in_fp32=True,
              norm_type="rms")
    time_against_plain("fused_add_norm fp32 D=3200", k2.fused_add_norm, k2.fused_add_norm_plain,
                       nk, KERNEL_TOL, {"fp32": 8 * b * L * e}, plain_iters=0,
                       repeat_identical=True)
    wide = dict(x=nk["x"], weight=nk["weight"], residual=nk["residual"],
                g_out=randn((b, L, e), g, device), g_resout=randn((b, L, e), g, device),
                prenorm=True, norm_type="rms")
    res = time_against_plain("fused_add_norm_bwd fp32 D=3200", k2.fused_add_norm_bwd,
                             k2.fused_add_norm_bwd_plain, wide, GRAD_TOL,
                             {"fp32": 12 * b * L * e}, plain_iters=0, repeat_identical=True)
    launch_split("fused_add_norm_bwd fp32 D=3200", k2.fused_add_norm_bwd, wide,
                 bound_ms=res["bound_ms"], iters=30)
    del wide

    counts = {name: 0 for name in WRAPPERS}
    x = randn((b, L, BASE["embed"]), g, device)
    for label, layer, want in (
            ("Mamba(d_conv=9)", Mamba(BASE["embed"], d_conv=9, device=device,
                                      generator=torch.Generator().manual_seed(3)),
             dict(mixer_fused=1, mixer_bwd=1)),
            ("Mamba2(d_conv=9)", mamba2_mod.Mamba2(BASE["embed"], d_state=64, d_conv=9,
                                                   headdim=64, chunk_size=128, device=device,
                                                   generator=torch.Generator().manual_seed(4)),
             dict(ssd_mixer=1, ssd_mixer_bwd=1))):
        before = launches()
        out, grads = layer_step(layer, x, plain=False)
        used = delta(launches(), before)
        expect_launches(f"{label} train step", used, **want)
        counts = {k: counts[k] + used[k] for k in counts}
        ref, want_grads = layer_step(layer, x, plain=True)
        check_close(f"{label} output vs plain", out, ref, KERNEL_TOL)
        # A parameter's gradient sums a kernel output over all B L rows in
        # torch (dt_bias: 1569 rows of K13's ddt, itself within 4e-7), so it
        # is held to the train-step bar; the kernels above hold 2e-5.
        for name, grad in grads.items():
            check_close(f"{label} d{name} vs plain", grad, want_grads[name], STEP_GRAD_TOL)
    w5 = [randn((1, L, BASE["d_inner"]), g, device), randn((5, BASE["d_inner"]), g, device, 0.5),
          randn((BASE["d_inner"],), g, device, 0.1)]
    before = launches()
    y = causal_conv1d(*w5, use_kernel=True)
    used = delta(launches(), before)
    expect_launches("causal_conv1d width 5", used, causal_conv=1)
    counts = {k: counts[k] + used[k] for k in counts}
    check_close("causal_conv1d width 5 vs plain composition", y, causal_conv1d(*w5),
                KERNEL_TOL)
    return counts


MASK_GRID = (8, IMG // 16, IMG // 16)  # Base: 8 frames of 14 x 14 patches
MASK_RATIO = 0.75                      # VideoMAE's tube ratio: 49 of 196 visible


def tube_mask(batch, frames=None, with_cls=True, seed=0):
    """A seeded VideoMAE tube mask (True = hidden) over ``frames`` (default:
    all 8) of the 14 x 14 grid: at Base, 1 + 8 * 49 = 393 visible tokens a
    clip."""
    grid = MASK_GRID if frames is None else (frames,) + MASK_GRID[1:]
    return TubeMaskingGenerator(grid, MASK_RATIO, with_cls=with_cls)(
        batch, rng=np.random.default_rng(seed))


def masked_batch(batch, device, mask, seed=2, video=None):
    """A seeded clip (or ``video``), the mask, and a noise target for the
    visible patch tokens."""
    g = torch.Generator().manual_seed(seed)
    if video is None:
        video = torch.randn((batch, 3, 8, IMG, IMG), generator=g)
    visible = int((~mask[0, 1:]).sum())
    target = torch.randn((batch, visible, BASE["embed"]), generator=g)
    return {"video": video.to(device), "target": target.to(device), "mask": mask}


def phase_masked_serving(device, sd0, depth):
    """Masked Base serving at B=2 (a 0.75 tube mask, 393 visible tokens):
    fp32 K2 25, K3 24 against the plain path (1e-4), per-frame pooling
    through the masked temporal average; bf16 K4 24, K2 1 against the same
    Blocks' plain versions (2e-2); videomamba_base_m2 fp32 K14 24 against
    the plain chunked SSD (1e-4); a masked two-chunk StreamingSession, each
    chunk against the same model's single-chunk forward from the same state
    and the plain path's session (1e-4)."""
    mask = tube_mask(2)
    clip2 = torch.randn((2, 3, 8, IMG, IMG), generator=torch.Generator().manual_seed(26)).to(device)
    visible = int((~mask[0]).sum())
    print(f"masked serving: tube mask ratio {MASK_RATIO} on {MASK_GRID}, B=2, "
          f"{visible} visible tokens a clip")
    fast = base_model(device, sd0).eval()
    plain = base_model(device, sd0, fused_add_norm=False,
                       ssm_cfg={"use_fast_path": False}).eval()
    before = launches()
    x_vis, x_pool = fast(clip2, mask=mask, keep_temporal=True)
    torch.cuda.synchronize()
    used = delta(launches(), before)
    expect_launches("masked fp32 forward", used, fused_add_norm=depth + 1, mixer_fused=depth,
                    block_fused=0)
    check(x_vis.shape == (2, visible - 1, BASE["embed"]), f"masked x_vis {tuple(x_vis.shape)}")
    check(x_pool.shape == (2, 8, BASE["embed"]), f"masked x_pool {tuple(x_pool.shape)}")
    p_vis, p_pool = plain(clip2, mask=mask, keep_temporal=True)
    check_close("masked fp32 x_vis vs plain", x_vis, p_vis, MODEL_TOL)
    check_close("masked fp32 x_pool (masked temporal average) vs plain", x_pool, p_pool,
                MODEL_TOL)
    # A CUDA mask is copied to the host once and gives the same result.
    again, _ = fast(clip2, mask=torch.from_numpy(mask).to(device), keep_temporal=True)
    check(torch.equal(again, x_vis), "masked fp32: a CUDA mask gave other tokens")

    bf16 = cast_module_for_compute(copy.deepcopy(fast), torch.bfloat16)
    seen = {}
    hook = bf16.layers[0].register_forward_pre_hook(
        lambda module, args: seen.setdefault("tokens", args[0]))
    before = launches()
    b_vis, b_pool = bf16(clip2, mask=mask, keep_temporal=True)
    torch.cuda.synchronize()
    hook.remove()
    used_b = delta(launches(), before)
    expect_launches("masked bf16 forward", used_b, block_fused=depth, fused_add_norm=1,
                    mixer_fused=0)
    check(seen["tokens"].shape[1] == visible, f"bf16 Blocks saw {seen['tokens'].shape[1]} tokens")
    check(bool(torch.isfinite(b_pool).all()), "masked bf16: non-finite x_pool")
    check_close("masked bf16 x_vis vs plain Blocks", b_vis,
                plain_blocks(bf16, seen["tokens"])[:, 1:], BF16_MODEL_TOL)
    del bf16

    session, plain_session = StreamingSession(fast, 2), StreamingSession(plain, 2)
    for c, m in enumerate((tube_mask(2, frames=4, seed=1),
                           tube_mask(2, frames=4, with_cls=False, seed=2))):
        chunk = clip2[:, :, 4 * c:4 * c + 4]
        state = [(conv.clone(), ssm.clone()) for conv, ssm in session.state]
        offset = session.offset
        before = launches()
        s_vis, s_pool = session.process(chunk, mask=m, keep_temporal=True)
        torch.cuda.synchronize()
        used_s = delta(launches(), before)
        check(used_s["mixer_fused"] == depth, f"masked chunk {c}: K3 {used_s['mixer_fused']}")
        one_vis, one_pool, _ = fast(chunk, mask=m, keep_temporal=True, ssm_state=state,
                                    temporal_pos_offset=offset)
        check_close(f"masked chunk {c} vs single-chunk forward from the same state",
                    s_vis, one_vis, MODEL_TOL)
        p_vis, p_pool = plain_session.process(chunk, mask=m, keep_temporal=True)
        check_close(f"masked chunk {c} vs plain path", s_vis, p_vis, MODEL_TOL)
        check_close(f"masked chunk {c} pool vs plain path", s_pool, p_pool, MODEL_TOL)
    del fast, plain, session, plain_session
    torch.cuda.empty_cache()

    m2 = m2_model(device).eval()
    m2_plain = m2_model(device, m2.state_dict(), fused_add_norm=False).eval()
    before = launches()
    m_vis, m_pool = m2(clip2, mask=mask, keep_temporal=True)
    torch.cuda.synchronize()
    used_m = delta(launches(), before)
    expect_launches("masked m2 fp32 forward", used_m, fused_add_norm=depth + 1,
                    ssd_pmixer=depth, ssd_mixer=0)
    with env(VIDEOMAMBA_SSD_METHOD="chunked"):
        pm_vis, pm_pool = m2_plain(clip2, mask=mask, keep_temporal=True)
    check_close("masked m2 fp32 x_vis vs plain chunked SSD", m_vis, pm_vis, MODEL_TOL)
    check_close("masked m2 fp32 x_pool vs plain chunked SSD", m_pool, pm_pool, MODEL_TOL)
    del m2, m2_plain
    torch.cuda.empty_cache()


def phase_masked_train(device, sd0, depth, unmasked_ms):
    """``make_train_step`` with a tube mask in the batch (the default loss
    regresses the visible tokens), the bench recipe: fp32 at B=2 (K2 25, K3
    24, K6 24) against the plain path (loss 1e-5, gradients 1e-4); bf16
    over fp32 masters against the same step on plain versions (loss 1e-2,
    gradients 5e-2); then masked fp32 and bf16 steps at B=4 (median host ms
    of 5 after 2 warm, peak memory) beside phase 11's unmasked ones."""
    batch2 = masked_batch(2, device, tube_mask(2))
    fast = base_model(device, sd0)
    step = make_train_step(fast, adamw(fast))
    before = launches()
    metrics = step(batch2, torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    used = delta(launches(), before)
    expect_launches("masked fp32 train step", used, fused_add_norm=depth + 1,
                    mixer_fused=depth, mixer_bwd=depth, block_fused=0)
    grads = grads_of(fast)
    plain = base_model(device, sd0, fused_add_norm=False, ssm_cfg={"use_fast_path": False})
    plain_metrics = make_train_step(plain, adamw(plain))(batch2)
    torch.cuda.synchronize()
    check_close("masked fp32 train step loss vs plain", metrics["loss"].reshape(1),
                plain_metrics["loss"].reshape(1), 1e-5)
    compare_grads("masked fp32 train step vs plain", grads, grads_of(plain), STEP_GRAD_TOL)
    del plain, plain_metrics
    torch.cuda.empty_cache()

    load_state_dict(fast, sd0)
    step = make_train_step(fast, adamw(fast), compute_dtype=torch.bfloat16)
    before = launches()
    metrics = step(batch2, torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    used_b = delta(launches(), before)
    expect_launches("masked bf16 train step", used_b, fused_add_norm=depth + 1,
                    mixer_fused=depth, mixer_bwd=depth)
    check(all(p.dtype == torch.float32 for p in fast.parameters()), "masked bf16: masters not fp32")
    grads = grads_of(fast)
    load_state_dict(fast, sd0)
    with plain_versions():
        before = launches()
        plain_metrics = step(batch2, torch.Generator().manual_seed(1))
        torch.cuda.synchronize()
        check(launches() == before, "masked bf16 plain-version step launched a kernel")
    check_close("masked bf16 train step loss vs plain versions", metrics["loss"].reshape(1),
                plain_metrics["loss"].reshape(1), BF16_TOL)
    compare_grads("masked bf16 train step vs plain versions", grads, grads_of(fast),
                  BF16_STEP_TOL)

    batch4 = masked_batch(4, device, tube_mask(4, seed=4), seed=4)
    times = {}
    for tag, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        load_state_dict(fast, sd0)
        step = make_train_step(fast, adamw(fast), compute_dtype=dtype)
        times[tag] = timed_steps(step, batch4, f"masked {tag} train step (4,3,8,224,224), "
                                 f"{int((~batch4['mask'][0]).sum())} visible tokens")
    for tag, (ms, peak) in times.items():
        print(f"train step B=4 {tag}: masked {ms:.3f} ms ({peak:.2f} GiB peak), unmasked "
              f"{unmasked_ms[tag][0]:.3f} ms ({unmasked_ms[tag][1]:.2f} GiB peak, phase 11)")
    del fast, step
    torch.cuda.empty_cache()


def write_clips(root, n=8, frames=16, hw=(256, 320)):
    """``n`` seeded uint8 clips (T, H, W, 3) in two class directories,
    alternately ``.npy`` and ``.vraw``."""
    rng = np.random.default_rng(28)
    for i in range(n):
        d = os.path.join(root, f"class{i % 2}")
        os.makedirs(d, exist_ok=True)
        clip = rng.integers(0, 256, (frames,) + hw + (3,), dtype=np.uint8)
        if i % 2:
            np.save(os.path.join(d, f"clip{i}.npy"), clip)
        else:
            write_vraw(os.path.join(d, f"clip{i}.vraw"), clip)


def phase_from_files(device, sd0, depth):
    """8 seeded clips written to disk, ``make_clip_loader`` (train
    augmentation, 8 frames, 224 crops, B=2) over two pinned epochs, twice:
    bit-equal batches; the loader's clips/s; one masked fp32 step on a
    loaded batch (finite loss, K6 24)."""
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as root:
        write_clips(root)
        runs = []
        for _ in range(2):
            loader, n_cls = make_clip_loader(data_dir=root, train=True, clip_len=8, crop=IMG,
                                             batch_size=2, num_threads=4)
            try:
                t0 = time.perf_counter()
                epochs = [list(loader.epoch(seed=0, shuffle=True, epoch=e)) for e in (0, 1)]
                secs = time.perf_counter() - t0
            finally:
                loader.close()
            runs.append(epochs)
            print(f"clip loader: 2 epochs of 8 clips (16 x 256 x 320 -> 3 x 8 x 224 x 224) in "
                  f"{secs * 1e3:.1f} ms, {16 / secs:.1f} clips/s")
    check(n_cls == 2, f"clip loader: {n_cls} classes")
    for e in range(2):
        check(len(runs[0][e]) == 4, f"clip loader: {len(runs[0][e])} batches in epoch {e}")
        for (a, la), (b, lb) in zip(runs[0][e], runs[1][e]):
            check(a.shape == (2, 3, 8, IMG, IMG) and a.dtype == torch.float32,
                  f"clip loader batch {tuple(a.shape)} {a.dtype}")
            check(torch.equal(a, b) and torch.equal(la, lb),
                  f"clip loader: epoch {e} differs between two loaders of one seed")
    check(not torch.equal(runs[0][0][0][0], runs[0][1][0][0]) or
          not torch.equal(runs[0][0][0][1], runs[0][1][0][1]),
          "clip loader: epochs 0 and 1 drew the same first batch")
    print("clip loader: two loaders of one seed gave bit-equal batches over epochs 0 and 1")

    clips, _ = runs[0][0][0]
    model = base_model(device, sd0)
    step = make_train_step(model, adamw(model))
    batch = masked_batch(2, device, tube_mask(2, seed=5), seed=5, video=clips)
    before = launches()
    metrics = step(batch, torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    used = delta(launches(), before)
    expect_launches("masked fp32 step on a loaded batch", used, fused_add_norm=depth + 1,
                    mixer_fused=depth, mixer_bwd=depth)
    check(bool(torch.isfinite(metrics["loss"])), "masked step on a loaded batch: non-finite loss")
    print(f"masked fp32 step on a loaded batch: loss {float(metrics['loss']):.6f}")
    del model, step
    torch.cuda.empty_cache()


def phase_refiner(device, tokens):
    """``BiMambaRefinerBlock(768)`` (Base ssm config, RMSNorm, fused
    add-norm, fp32 residual) on phase 2's (1, 8, 196, 768) patch tokens:
    fp32 K2 2, K3 2 against the same weights on the plain path (1e-4);
    bf16 K4 2 against the same refiner on plain versions (2e-2); the
    forward state after two 4-frame calls against one 8-frame call (1e-4)."""
    g = torch.Generator().manual_seed(29)
    refiner = BiMambaRefinerBlock(BASE["embed"], device=device, generator=g, layer_idx=0).eval()
    plain = BiMambaRefinerBlock(BASE["embed"], device=device, fused_add_norm=False,
                                ssm_cfg={"use_fast_path": False}, layer_idx=0).eval()
    load_state_dict(plain, refiner.state_dict())
    before = launches()
    out, state = refiner(tokens)
    torch.cuda.synchronize()
    used = delta(launches(), before)
    expect_launches("refiner fp32", used, fused_add_norm=2, mixer_fused=2, block_fused=0)
    check(out.shape == tokens.shape, f"refiner output {tuple(out.shape)}")
    p_out, p_state = plain(tokens)
    check_close("refiner fp32 vs plain", out, p_out, MODEL_TOL)
    for name, got, want in zip(("conv", "ssm"), state, p_state):
        check_close(f"refiner fp32 forward {name} state vs plain", got, want, MODEL_TOL)

    _, half = refiner(tokens[:, :4])
    _, half = refiner(tokens[:, 4:], state_fwd=half)
    torch.cuda.synchronize()
    for name, got, want in zip(("conv", "ssm"), half, state):
        check_close(f"refiner forward {name} state, two 4-frame calls vs one 8-frame call",
                    got, want, MODEL_TOL)

    bf16 = cast_module_for_compute(copy.deepcopy(refiner), torch.bfloat16)
    x16 = tokens.bfloat16()
    before = launches()
    b_out, _ = bf16(x16)
    torch.cuda.synchronize()
    used_b = delta(launches(), before)
    expect_launches("refiner bf16", used_b, block_fused=2, mixer_fused=0, fused_add_norm=0)
    check(b_out.dtype == torch.bfloat16, f"refiner bf16 output {b_out.dtype}")
    with plain_versions():
        pb_out, _ = bf16(x16)
    check_close("refiner bf16 vs plain versions", b_out, pb_out, BF16_MODEL_TOL)
    del refiner, plain, bf16
    torch.cuda.empty_cache()


def phase_files_and_determinism(device, sd0, full_vis, clip, depth):
    """Phase 2's weights written with ``save_torch_state_dict`` and read
    back with ``load_checkpoint`` into a fresh Base model on the card:
    bit-equal parameters and phase 2's forward; the same weights with a
    seeded temporal embedding into a 16-frame model (temporal 8 -> 16,
    linear, against ``F.interpolate``, 1e-6) and a 16-frame clip through
    it; then ``configure_determinism(0, deterministic=True)`` and the
    masked fp32 step twice from the same weights: bit-identical loss and
    gradients. Restores TF32 off and non-deterministic mode after it."""
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        path, path_t = os.path.join(tmp, "base.pt"), os.path.join(tmp, "base_t.pt")
        with torch.inference_mode():
            model = base_model(device, sd0)
            save_torch_state_dict(path, model)
            temporal = 0.02 * torch.randn(model.temporal_pos_embedding.shape,
                                          generator=torch.Generator().manual_seed(30))
            model.temporal_pos_embedding.copy_(temporal)
            save_torch_state_dict(path_t, model)
            del model
            print(f"checkpoint file: {os.path.getsize(path) / 2**20:.1f} MiB")
            loaded = videomamba_base(pool_type="avg", device=device,
                                     generator=torch.Generator().manual_seed(30)).eval()
            load_checkpoint(path, loaded, ckpt_num_frame=8, num_frames=8)
            for name, value in loaded.state_dict().items():
                check(torch.equal(value, sd0[name]), f"checkpoint round trip: {name} differs")
            x_vis, _ = loaded(clip)
            torch.cuda.synchronize()
            check(torch.equal(x_vis, full_vis), "checkpoint round trip: forward differs "
                  f"from phase 2's (rel_err {rel_err(x_vis, full_vis):.3e})")
            print("checkpoint round trip: bit-equal parameters and forward")
            del loaded
            long = videomamba_base(pool_type="avg", num_frames=16, device=device,
                                   generator=torch.Generator().manual_seed(31)).eval()
            load_checkpoint(path_t, long, ckpt_num_frame=8, num_frames=16)
            want = torch.nn.functional.interpolate(
                temporal.to(device).permute(0, 2, 1), size=16, mode="linear",
                align_corners=False).permute(0, 2, 1)
            check_close("16-frame temporal embedding vs F.interpolate",
                        long.temporal_pos_embedding, want, 1e-6)
            clip16 = torch.randn((1, 3, 16, IMG, IMG),
                                 generator=torch.Generator().manual_seed(30)).to(device)
            v16, p16 = long(clip16)
            torch.cuda.synchronize()
            check(v16.shape == (1, 16 * (IMG // 16) ** 2, BASE["embed"])
                  and bool(torch.isfinite(v16).all())
                  and bool(torch.isfinite(p16).all()), f"16-frame forward {tuple(v16.shape)}")
            print(f"16-frame forward from an 8-frame checkpoint: x_vis {tuple(v16.shape)}")
            del long
    torch.cuda.empty_cache()

    batch2 = masked_batch(2, device, tube_mask(2))
    runs = []
    try:
        cfg = configure_determinism(0, deterministic=True, warn_only=False)
        print(f"determinism: {cfg}, CUBLAS_WORKSPACE_CONFIG="
              f"{os.environ.get('CUBLAS_WORKSPACE_CONFIG')}")
        model = base_model(device, sd0)
        for _ in range(2):
            load_state_dict(model, sd0)
            metrics = make_train_step(model, adamw(model))(batch2)
            torch.cuda.synchronize()
            runs.append((metrics["loss"].clone(), grads_of(model)))
    finally:
        configure_determinism(0, deterministic=False, cudnn_benchmark=False, allow_tf32=False)
    (loss_a, grads_a), (loss_b, grads_b) = runs
    check(torch.equal(loss_a, loss_b), "deterministic masked step: losses differ")
    differ = [k for k in grads_a if not torch.equal(grads_a[k], grads_b[k])]
    check(not differ, f"deterministic masked step: gradients of {differ} differ")
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
          and not torch.are_deterministic_algorithms_enabled(), "determinism not restored")
    print(f"deterministic masked fp32 step twice: bit-identical loss {float(loss_a):.6f} "
          f"and {len(grads_a)} gradients")
    del model
    torch.cuda.empty_cache()


SP_FRAMES = 16  # a 16-frame clip, 3136 tokens: what users shard time for
SP_SHARDS = 4


def init_nccl_world():
    """A one-rank NCCL process group through ``init_distributed_mode``, the
    entry point a user calls (torchrun's RANK, WORLD_SIZE and LOCAL_RANK,
    a file rendezvous under build/). Returns the rendezvous file."""
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    path = os.path.join(build, f"nccl_rendezvous_{os.getpid()}")
    if os.path.exists(path):
        os.remove(path)
    saved = {k: os.environ.get(k) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    try:
        init_distributed_mode(SimpleNamespace(dist_url="file://" + path))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(dist.get_backend() == "nccl", f"process group backend {dist.get_backend()}, not nccl")
    print(f"NCCL {'.'.join(map(str, torch.cuda.nccl.version()))} world of "
          f"{dist.get_world_size()} rank")
    return path


def forward_and_grads(fn, leaves, cot):
    """``fn()``'s outputs (detached) and the gradients of its first output
    under ``cot`` with respect to ``leaves``."""
    outs = fn()
    grads = torch.autograd.grad(outs[0], leaves, cot)
    return [o.detach() for o in outs], grads


def compare_grad_lists(label, names, got, want, tol):
    compare_grads(label, dict(zip(names, got)), dict(zip(names, want)), tol)


def phase_sequence_parallel(device):
    """Phase A: a Base Mamba-1 Block over a 16-frame clip (L 3136) split
    into 4 time shards, run through the ranks' functions on one card, and a
    Base-m2 mixer through ``sequence_parallel_ssd(method="pallas")``'s; then
    the public ``sequence_parallel_mixer`` on the NCCL group."""
    e = BASE["embed"]
    L = SP_FRAMES * (IMG // 16) ** 2
    g = torch.Generator().manual_seed(31)
    block = create_block(e, rms_norm=True, residual_in_fp32=True, fused_add_norm=True,
                         layer_idx=0, device=device, generator=g).train()
    hidden = randn((1, L, e), g, device).requires_grad_()
    residual = randn((1, L, e), g, device).requires_grad_()
    cot = randn((1, L, e), g, device)
    state0 = block.allocate_state(1)
    names = ["hidden", "residual"] + [n for n, _ in block.named_parameters()]
    leaves = [hidden, residual] + list(block.parameters())

    def single():
        out, _, (conv, ssm) = block(hidden, residual, state=state0, return_state=True)
        return out, conv, ssm

    def sharded():
        normed = [fused_add_norm(h, block.norm.weight, None, residual=r, prenorm=True,
                                 residual_in_fp32=True, eps=block.norm_epsilon,
                                 norm_type="rms", use_kernel=True)[0]
                  for h, r in zip(hidden.chunk(SP_SHARDS, 1), residual.chunk(SP_SHARDS, 1))]
        out, (conv, ssm) = sequence_parallel_mixer_shards(
            block.mixer, torch.cat(normed, 1), SP_SHARDS, state=state0, return_state=True)
        return out, conv, ssm

    (r_out, r_conv, r_ssm), r_grads = forward_and_grads(single, leaves, cot)
    zero_launches()
    (out, conv, ssm), grads = forward_and_grads(sharded, leaves, cot)
    torch.cuda.synchronize()
    used = launches()
    expect_launches(f"sequence-parallel Block, {SP_SHARDS} shards of {L // SP_SHARDS}", used,
                    selective_scan=SP_SHARDS, selective_scan_bwd=SP_SHARDS,
                    fused_add_norm=SP_SHARDS, mixer_fused=0, mixer_bwd=0)
    check_close("SP Block output vs single-card Block (K3)", out, r_out, MODEL_TOL)
    check_close("SP Block conv_state", conv, r_conv, MODEL_TOL)
    check_close("SP Block ssm_state", ssm, r_ssm, MODEL_TOL)
    compare_grad_lists("SP Block vs single-card Block (K6)", names, grads, r_grads,
                       STEP_GRAD_TOL)
    for label, fn in (("single-card Block (K2, K3 / K6)", single),
                      (f"SP Block, {SP_SHARDS} shards (K2, K1 / K5)", sharded)):
        wall, dev_ms = device_ms(lambda: forward_and_grads(fn, leaves, cot), 3)
        print(f"{label}: forward + backward {dev_ms if dev_ms is None else round(dev_ms, 4)} "
              f"device ms, {wall:.3f} host ms")

    cfg = {k: v for k, v in M2_SSM_CFG.items() if k != "layer"}
    m2 = Mamba2(e, **cfg, device=device, generator=g)
    x2 = randn((1, L, e), g, device).requires_grad_()
    names2 = ["x"] + [n for n, _ in m2.named_parameters()]
    leaves2 = [x2] + list(m2.parameters())
    (r_out2,), r_grads2 = forward_and_grads(lambda: (m2(x2),), leaves2, cot)
    zero_launches()
    (out2,), grads2 = forward_and_grads(
        lambda: (sequence_parallel_mixer_m2_shards(m2, x2, SP_SHARDS, method="pallas"),),
        leaves2, cot)
    torch.cuda.synchronize()
    used_m2 = launches()
    expect_launches("sequence-parallel Base-m2 mixer, method pallas", used_m2,
                    ssd_scan=SP_SHARDS, ssd_scan_bwd=SP_SHARDS, ssd_mixer=0, ssd_mixer_bwd=0)
    check_close("SP m2 mixer output vs single-card Mamba2 (K12)", out2, r_out2, MODEL_TOL)
    compare_grad_lists("SP m2 mixer vs single-card Mamba2 (K13)", names2, grads2, r_grads2,
                       STEP_GRAD_TOL)
    for label, fn in (("single-card m2 mixer (K12 / K13)", lambda: (m2(x2),)),
                      (f"SP m2 mixer, {SP_SHARDS} shards (K11)", lambda: (
                          sequence_parallel_mixer_m2_shards(m2, x2, SP_SHARDS,
                                                            method="pallas"),))):
        wall, dev_ms = device_ms(lambda: forward_and_grads(fn, leaves2, cot), 3)
        print(f"{label}: forward + backward {dev_ms if dev_ms is None else round(dev_ms, 4)} "
              f"device ms, {wall:.3f} host ms")

    with torch.no_grad():
        normed = fused_add_norm(hidden, block.norm.weight, None, residual=residual, prenorm=True,
                                residual_in_fp32=True, eps=block.norm_epsilon,
                                norm_type="rms", use_kernel=True)[0]
        zero_launches()
        out_pub, (conv_pub, ssm_pub) = sequence_parallel_mixer(
            block.mixer, normed, group=dist.group.WORLD, state=state0, return_state=True)
        torch.cuda.synchronize()
        used_pub = launches()
        out_one, (conv_one, ssm_one) = sequence_parallel_mixer_shards(
            block.mixer, normed, 1, state=state0, return_state=True)
    expect_launches("public sequence_parallel_mixer on the NCCL group", used_pub,
                    selective_scan=1)
    for name, a, b in (("out", out_pub, out_one), ("conv_state", conv_pub, conv_one),
                       ("ssm_state", ssm_pub, ssm_one)):
        check(torch.equal(a, b), f"NCCL sequence_parallel_mixer {name} != single-shard path")
    print("public sequence_parallel_mixer on the NCCL group: equal to the single-shard path")
    return {k: used[k] + used_m2[k] + used_pub[k] for k in used}


def phase_tensor_parallel(device):
    """Phase B: a Base Mamba-1 mixer split over 2 tensor-parallel ranks
    (d_inner 768 each) through the ranks' function on one card, the parts
    summed where the all-reduces run, against the single-card mixer."""
    g = torch.Generator().manual_seed(32)
    mixer = Mamba(BASE["embed"], device=device, generator=g)
    x = randn((1, BASE["seqlen"], BASE["embed"]), g, device).requires_grad_()
    cot = randn((1, BASE["seqlen"], BASE["embed"]), g, device)
    names = [n for n, _ in mixer.named_parameters()]
    (r_out,), r_grads = forward_and_grads(lambda: (mixer(x),), [x] + list(mixer.parameters()),
                                          cot)
    shards = [copy.deepcopy(mixer).keep_channels(k, 2) for k in range(2)]
    joined = Mamba.join_channel_slices([dict(s.named_parameters()) for s in shards])
    for n, p in mixer.named_parameters():
        check(torch.equal(joined[n], p), f"tp: gathered {n} is not the unsplit parameter")
    print("tp=2: gathered parameters bit-equal to the unsplit ones")
    leaves = [x] + [p for s in shards for p in s.parameters()]
    zero_launches()
    (out,), grads = forward_and_grads(lambda: (tensor_parallel_shards(shards, x),), leaves, cot)
    torch.cuda.synchronize()
    used = launches()
    expect_launches("tensor-parallel Base mixer, tp=2", used, selective_scan=2,
                    selective_scan_bwd=2, mixer_fused=0, mixer_bwd=0)
    check_close("tp=2 mixer output vs single-card mixer (K3)", out, r_out, KERNEL_TOL)
    per = len(names)
    shard_grads = [dict(zip(names, grads[1 + k * per:1 + (k + 1) * per])) for k in range(2)]
    got = Mamba.join_channel_slices(shard_grads)
    compare_grads("tp=2 mixer vs single-card mixer (K6)", {"x": grads[0], **got},
                  {"x": r_grads[0], **dict(zip(names, r_grads[1:]))}, STEP_GRAD_TOL)
    return used


def phase_sharded_train(device, sd0, depth, unsharded):
    """Phase C: phase 11's Base B=4 steps under ``init_train_state(mesh=
    make_mesh({"dp": 1, "fsdp": 1, "tp": 1}))`` on the NCCL group (FSDP2
    over one rank): three fp32 steps against the unsharded step from the
    same weights, then the bench recipe's times; the same for bf16."""
    mesh = make_mesh({"dp": 1, "fsdp": 1, "tp": 1})
    batch_cmp = train_batch(4, device, zero_target=False)
    batch4 = train_batch(4, device)
    counts = {name: 0 for name in WRAPPERS}
    for tag, dtype, steps, loss_tol, tol in (("fp32", None, 3, 1e-5, 1e-5),
                                             ("bf16", torch.bfloat16, 1, BF16_TOL,
                                              BF16_STEP_TOL)):
        ref = base_model(device, sd0)
        ref_step = make_train_step(ref, adamw(ref), compute_dtype=dtype)
        model = base_model(device, sd0)
        opt = adamw(model)
        init_train_state(model, opt, mesh=mesh)
        step = make_train_step(model, opt, compute_dtype=dtype)
        for i in range(steps):
            want = ref_step(batch_cmp)
            before = launches()
            got = step(batch_cmp)
            torch.cuda.synchronize()
            used = delta(launches(), before)
            counts = {k: counts[k] + used[k] for k in counts}
            expect_launches(f"sharded {tag} train step {i}", used, fused_add_norm=depth + 1,
                            mixer_fused=depth, mixer_bwd=depth)
            for key in ("loss", "grad_norm"):
                check_close(f"sharded {tag} step {i} {key} vs unsharded",
                            got[key].reshape(1).float(), want[key].reshape(1).float(),
                            loss_tol)
        if dtype is None:
            full = full_state_dict(model)
            worst = max((rel_err(full[n], p.detach()), n) for n, p in ref.named_parameters())
            print(f"sharded fp32 parameters after {steps} steps: max rel_err {worst[0]:.3e} "
                  f"({worst[1]})")
            check(worst[0] <= tol, f"sharded fp32 parameter {worst[1]} rel_err {worst[0]:.3e}")
        else:
            got_g = {n: p.grad.full_tensor() for n, p in model.named_parameters()
                     if p.grad is not None}
            compare_grads("sharded bf16 step vs unsharded", got_g, grads_of(ref), tol)
        for label, fn in (("unsharded", ref_step), ("FSDP2 over one rank", step)):
            wall, dev_ms = device_ms(lambda: fn(batch4), 2, f"{tag} {label}", top=4)
            print(f"train step B=4 {tag}, {label}, under the profiler: {wall:.3f} host ms, "
                  f"{dev_ms if dev_ms is None else round(dev_ms, 3)} device ms")
        del ref, ref_step
        torch.cuda.empty_cache()
        ms, peak = timed_steps(step, batch4, f"sharded {tag} train step (4,3,8,224,224)")
        print(f"train step B=4 {tag}: FSDP2 over one rank {ms:.3f} ms ({peak:.2f} GiB peak), "
              f"unsharded {unsharded[tag][0]:.3f} ms ({unsharded[tag][1]:.2f} GiB peak, "
              f"phase 11)")
        del model, opt, step
        torch.cuda.empty_cache()
    # FSDP2's parameters are DTensors, whose every op the foreach AdamW
    # dispatches on the host; the fused AdamW takes one launch a group.
    model = base_model(device, sd0)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=0.05, fused=True)
    init_train_state(model, opt, mesh=mesh)
    ms, peak = timed_steps(make_train_step(model, opt), batch4,
                           "sharded fp32 train step (4,3,8,224,224), fused AdamW")
    print(f"train step B=4 fp32: FSDP2 over one rank with fused AdamW {ms:.3f} ms "
          f"({peak:.2f} GiB peak)")
    del model, opt
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------- phases D-J

CHUNK = 64  # the serving example's chunk (examples/streaming_serving.py:22-23)
HEADLINE_FRAMES = 256  # four chunks of 64 frames: L 12,544 a chunk at Base
BF16_FEATURE_TARGET = 1e-3  # BASELINE.md's bf16-vs-fp32 feature target


def load_entry(relpath: str):
    """A script or example of the checkout as a module (its main not run)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), relpath)
    spec = importlib.util.spec_from_file_location(
        "entry_" + relpath.replace("/", "_")[:-3], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def build_dir() -> str:
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(path, exist_ok=True)
    return path


def restore_modes() -> None:
    """chip_smoke's process-wide modes: non-deterministic, TF32 off."""
    configure_determinism(0, deterministic=False, cudnn_benchmark=False, allow_tf32=False)


def phase_ops_surface(device):
    """Phase D: ``selective_scan_bld`` at Base shapes with "chunked",
    "pallas" and "kernel" (each one K1 launch, against "ref", the
    sequential plain version, at 1e-5), the reference-layout
    ``selective_scan`` (bit-equal to the (B, L, D) call), and a Base-width
    unfused ``Mamba`` (K1 route) with ``scan_chunk_size=32`` bit-equal to
    one without it."""
    from videomamba_tpu_torch.ops import selective_scan, selective_scan_bld

    kw = kernel_inputs(BASE, device, seed=40)["selective_scan"]
    args = dict(u=kw["u"], delta=kw["delta"], A=kw["A"], B=kw["B"], C=kw["C"], D=kw["D"],
                z=kw["z"], delta_bias=kw["delta_bias"], delta_softplus=True,
                initial_state=kw["h0"], return_last_state=True)
    want_y, want_h = selective_scan_bld(**args, method="ref")
    got = {}
    for method in ("chunked", "pallas", "kernel"):
        n0 = k1.selective_scan.launches
        got[method] = selective_scan_bld(**args, method=method)
        torch.cuda.synchronize()
        n = k1.selective_scan.launches - n0
        check(n == 1, f"selective_scan_bld(method={method!r}): {n} K1 launches, not 1")
        check_close(f"selective_scan_bld {method} y vs ref", got[method][0], want_y, KERNEL_TOL)
        check_close(f"selective_scan_bld {method} h vs ref", got[method][1], want_h, KERNEL_TOL)
    ref_layout = {k: (v.transpose(1, 2) if k in ("u", "delta", "B", "C", "z") else v)
                  for k, v in args.items()}
    y_t, h_t = selective_scan(**ref_layout)
    check(torch.equal(y_t.transpose(1, 2), got["chunked"][0])
          and torch.equal(h_t, got["chunked"][1]),
          "reference-layout selective_scan differs from selective_scan_bld")
    print("reference-layout selective_scan (B, D, L): bit-equal to the (B, L, D) call")
    x = randn((1, BASE["seqlen"], BASE["embed"]), torch.Generator().manual_seed(41), device)
    outs = []
    for extra in ({}, {"scan_chunk_size": 32}):
        layer = Mamba(BASE["embed"], conv_bias=False, device=device,
                      generator=torch.Generator().manual_seed(42), **extra).eval()
        n0 = k1.selective_scan.launches
        outs.append(layer(x))
        torch.cuda.synchronize()
        check(k1.selective_scan.launches - n0 == 1, f"Mamba({extra}): K1 not launched once")
    check(torch.equal(outs[0], outs[1]), "Mamba(scan_chunk_size=32) differs from the default")
    print("Mamba(768, conv_bias=False, scan_chunk_size=32): bit-equal to the default, "
          "one K1 launch each")


def phase_streaming_cli(device):
    """Phase E: ``check_streaming_state_torch.main`` on a Base-width layer
    over 16 frames of tokens (L 3136, split at 1568) on the fused mixer
    (K3 forward, K6 backward), TF32 off as everywhere here."""
    cli = load_entry("scripts/check_streaming_state_torch.py")
    before = launches()
    try:
        max_diff = cli.main(["--d-model", str(BASE["embed"]), "--seqlen", "3136", "--split",
                             "1568", "--fast-path", "--allow-tf32", "off"])
    finally:
        restore_modes()
    torch.cuda.synchronize()
    used = delta(launches(), before)
    print(f"streaming check at d_model 768, L 3136 split at 1568: max |diff| {max_diff:.3e} "
          f"(rtol / atol 1e-4); K3 {used['mixer_fused']}, K6 {used['mixer_bwd']} launches, "
          f"K1 {used['selective_scan']}")
    check(used["mixer_fused"] == 5 and used["mixer_bwd"] == 2,
          f"streaming check: expected K3 5 (3 forward, 2 under autograd) and K6 2, got {used}")


def base_cli_model(device, frames=8, seed=43):
    """A seeded Base model of the checkpoint CLI's configuration (pool
    'cls+avg', pool norm) with a nonzero temporal embedding."""
    from videomamba_tpu_torch.models import PretrainVideoMamba

    model = PretrainVideoMamba(img_size=IMG, patch_size=16, depth=24, embed_dim=BASE["embed"],
                               num_frames=frames, device=device,
                               generator=torch.Generator().manual_seed(seed)).eval()
    with torch.no_grad():
        model.temporal_pos_embedding.copy_(0.02 * torch.randn(
            model.temporal_pos_embedding.shape, generator=torch.Generator().manual_seed(seed)))
    return model


def phase_checkpoint_cli(device):
    """Phase F: a seeded Base model written as a reference ``.pt``,
    converted ``to-native`` and back ``to-torch`` (bit-equal files); the
    model the CLI loaded from the native file gives the source's features
    bit for bit (fp32, (1, 3, 8, 224, 224)); the same file to a 16-frame
    model (``--ckpt-num-frame 8``) against ``load_checkpoint``."""
    cli = load_entry("scripts/convert_checkpoint_torch.py")
    geom = ["--embed-dim", str(BASE["embed"]), "--depth", "24"]
    clip = torch.randn((1, 3, 8, IMG, IMG), generator=torch.Generator().manual_seed(44)).to(device)
    with tempfile.TemporaryDirectory(dir=build_dir()) as tmp:
        ref, native, back = (os.path.join(tmp, f) for f in ("ref.pt", "native.pt", "back.pt"))
        src = base_cli_model(device)
        save_torch_state_dict(ref, src)
        loaded = cli.main(["to-native", ref, native, *geom, "--num-frames", "8"]).eval()
        cli.main(["to-torch", native, back, *geom, "--num-frames", "8"])
        a, b = torch.load(ref, weights_only=True), torch.load(back, weights_only=True)
        check(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a),
              "checkpoint CLI: to-native then to-torch is not bit-equal")
        print(f"checkpoint CLI: {len(a)} tensors round-trip bit-equal "
              f"({os.path.getsize(ref) / 2**20:.1f} MiB .pt)")
        with torch.inference_mode():
            got, want = loaded(clip), src(clip)
            torch.cuda.synchronize()
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"checkpoint CLI: features differ (rel_err {rel_err(got[0], want[0]):.3e})")
        print("checkpoint CLI: the native file's model gives the source's features bit for bit")
        del loaded, src, got, want
        long = cli.main(["to-native", ref, native, *geom, "--num-frames", "16",
                         "--ckpt-num-frame", "8"]).eval()
        fresh = base_cli_model(device, frames=16, seed=45)
        load_checkpoint(ref, fresh, ckpt_num_frame=8, num_frames=16)
        sd_long, sd_fresh = long.state_dict(), fresh.state_dict()
        check(all(torch.equal(sd_long[k], sd_fresh[k]) for k in sd_fresh),
              "checkpoint CLI at 16 frames: parameters differ from load_checkpoint's")
        clip16 = torch.randn((1, 3, 16, IMG, IMG),
                             generator=torch.Generator().manual_seed(46)).to(device)
        with torch.inference_mode():
            check(all(torch.equal(g, w) for g, w in zip(long(clip16), fresh(clip16))),
                  "checkpoint CLI at 16 frames: features differ from load_checkpoint's")
        print("checkpoint CLI 8 -> 16 frames: parameters and a 16-frame forward bit-equal "
              "to load_checkpoint's")
        del long, fresh
    torch.cuda.empty_cache()


def clone_tree(x):
    """A copy of every tensor in nested tuples, lists and dicts."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, (tuple, list)):
        return type(x)(clone_tree(v) for v in x)
    if isinstance(x, dict):
        return {k: clone_tree(v) for k, v in x.items()}
    return x


def layer_vs_plain(tag, model, video, idx, tol):
    """Layer ``idx`` of ``model`` on its kernels, in a session over the
    first two chunks of ``video``: the first from a zero state (L 12,544 +
    CLS), the second from the state the first left (L 12,544). Its inputs
    and outputs are kept, then the same layer runs on the same inputs with
    every wrapper on its plain version (no launch), and each output (hidden,
    residual, conv window, SSM state) is held to it at ``tol``."""
    layer, calls = model.layers[idx], []

    def keep_inputs(module, args, kwargs):
        calls.append([clone_tree(args), clone_tree(kwargs)])

    def keep_outputs(module, args, kwargs, out):
        calls[-1].append(clone_tree(out))

    hooks = [layer.register_forward_pre_hook(keep_inputs, with_kwargs=True),
             layer.register_forward_hook(keep_outputs, with_kwargs=True)]
    session = StreamingSession(model, batch_size=video.shape[0], dtype=torch.float32)
    try:
        for t0 in (0, CHUNK):
            session.process(video[:, :, t0:t0 + CHUNK])
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    del session
    carried = calls[1][1]["state"]
    check(all(bool(s.abs().max() > 0) for s in carried),
          f"serving example {tag}: layer {idx} got a zero state at chunk 2")
    names = ("hidden", "residual", "conv window", "SSM state")
    for i, (args, kwargs, got) in enumerate(calls):
        before = launches()
        with all_plain(), torch.no_grad():
            want = layer(*args, **kwargs)
            torch.cuda.synchronize()
        used = {k: v for k, v in delta(launches(), before).items() if v}
        check(not used, f"serving example {tag}: the plain layer launched {used}")
        got, want = (got[0], got[1], *got[2]), (want[0], want[1], *want[2])
        for name, g, w in zip(names, got, want):
            check_close(f"serving example {tag}: layer {idx} {name}, chunk {i + 1} "
                        f"(L {args[0].shape[1]}) vs its plain version", g.float(), w.float(), tol)


def phase_serving_example(device):
    """Phase G: ``streaming_serving_torch.main`` at Base, 64-frame chunks
    of a 256-frame clip (L 12,544 a chunk), bf16 (K4 24 and K2 1 a chunk),
    ``--mamba2`` (K14 24, K2 25) and ``--fp32`` (K2 25, K3 24). The first
    chunk's x_vis against a full forward of those 64 frames (2e-2 bf16,
    1e-4 fp32); the last layer on its kernels against its plain version on
    the same inputs, at chunk 1 and at chunk 2 from the carried state
    (phases 6 and 17's 1e-2 for K4 and K14 at bf16, phase 2's 1e-5 for K3);
    the bf16 stream's pooled features against the fp32 stream's, gated at
    the 24-layer bf16 bar (2e-2) and printed beside BASELINE.md's 1e-3; each
    chunk's host ms and the median of chunks 2-4.
    Returns {tag: (median ms, frames/s)}."""
    example = load_entry("examples/streaming_serving_torch.py")
    argv = ["--chunk", str(CHUNK), "--frames", str(HEADLINE_FRAMES)]
    runs = (("bf16", [], BF16_MODEL_TOL, BF16_TOL, {"block_fused": 24, "fused_add_norm": 1,
                                                     "mixer_fused": 0}),
            ("m2 bf16", ["--mamba2"], BF16_MODEL_TOL, BF16_TOL,
             {"ssd_pmixer": 24, "fused_add_norm": 25}),
            ("fp32", ["--fp32"], MODEL_TOL, KERNEL_TOL, {"fused_add_norm": 25, "mixer_fused": 24,
                                                         "block_fused": 0}))
    pools, times = {}, {}
    chunks = HEADLINE_FRAMES // CHUNK
    for tag, extra, tol, layer_tol, per_chunk in runs:
        before = launches()
        r = example.main(argv + extra)
        torch.cuda.synchronize()
        used = delta(launches(), before)
        print(f"serving example {tag}: launches {used}")
        for name, n in per_chunk.items():
            check(used[name] == n * chunks,
                  f"serving example {tag}: {name} {used[name]} launches, expected {n * chunks}")
        tokens = r.first_vis.shape[1]
        check(tokens == CHUNK * (IMG // 16) ** 2, f"serving example {tag}: {tokens} tokens")
        with torch.no_grad():
            full_vis, _ = r.model(r.video[:, :, :CHUNK])
            torch.cuda.synchronize()
        check_close(f"serving example {tag}: first chunk x_vis (L {tokens}) vs full forward",
                    r.first_vis.float(), full_vis.float(), tol)
        del full_vis
        layer_vs_plain(tag, r.model, r.video, len(r.model.layers) - 1, layer_tol)
        pools[tag] = r.pools
        times[tag] = (r.median_ms, r.fps)
        print(f"serving example {tag}: chunk host ms {[round(t, 3) for t in r.chunk_ms]}, "
              f"median of chunks 2-{chunks} {r.median_ms:.3f} ms, {r.fps:.1f} frames/s")
        del r
        torch.cuda.empty_cache()
    errs = [rel_err(a, b) for a, b in zip(pools["bf16"], pools["fp32"])]
    print(f"serving example: bf16 vs fp32 pooled features per chunk "
          f"{['%.3e' % e for e in errs]}; BASELINE.md target {BF16_FEATURE_TARGET:g} "
          f"{'met' if max(errs) <= BF16_FEATURE_TARGET else 'not met'}, "
          f"bar {BF16_MODEL_TOL:g}")
    check(max(errs) <= BF16_MODEL_TOL,
          f"serving example: bf16 vs fp32 pooled features {max(errs):.3e} > {BF16_MODEL_TOL:g}")
    return times


def phase_masked_example(device):
    """Phase H: ``train_masked_pretrain_torch.main`` at Base width (depth
    24, img 224, 8 frames, B=4, 5 steps) on a world-1 mesh (FSDP2 over a
    one-rank NCCL group): finite losses, falling from step 0 to step 4;
    each step's host ms from ``StepTimer`` and the peak memory."""
    example = load_entry("examples/train_masked_pretrain_torch.py")
    torch.cuda.reset_peak_memory_stats()
    before = launches()
    r = example.main(["--embed-dim", str(BASE["embed"]), "--depth", "24", "--img", str(IMG),
                      "--frames", "8", "--batch", "4", "--steps", "5"])
    torch.cuda.synchronize()
    used = delta(launches(), before)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"masked example: launches {used}")
    print(f"masked example: losses {['%.6f' % v for v in r.losses]}, step host ms "
          f"{[round(1e3 * s, 3) for s in r.seconds]}, {peak:.2f} GiB peak, "
          f"{r.n_visible} visible tokens")
    check(all(np.isfinite(r.losses)), "masked example: non-finite loss")
    check(r.losses[-1] < r.losses[0], f"masked example: loss did not fall ({r.losses})")
    for name, n in (("fused_add_norm", 25), ("mixer_fused", 24), ("mixer_bwd", 24)):
        check(used[name] == 5 * n, f"masked example: {name} {used[name]} launches, not {5 * n}")
    check(not dist.is_initialized(), "masked example: left its process group")
    torch.cuda.empty_cache()


def phase_classifier_example(device):
    """Phase I: ``train_classifier_torch.main`` at Base width (depth 24,
    img 224, 8 frames, B=4, 2 epochs, 3 classes) under
    ``configure_determinism(0, deterministic=True)``: the train state
    (FSDP2 shards gathered) saved each epoch, the one before the last
    reloaded and the last epoch replayed: parameters bit-equal; the eval
    accuracy each epoch and the loader's clips/s."""
    example = load_entry("examples/train_classifier_torch.py")
    saved_tmp = tempfile.tempdir
    with tempfile.TemporaryDirectory(dir=build_dir()) as tmp:
        tempfile.tempdir = tmp  # the synthesized shards
        try:
            cfg = configure_determinism(0, deterministic=True)
            print(f"classifier example under {cfg}")
            before = launches()
            r = example.main(["--embed-dim", str(BASE["embed"]), "--depth", "24", "--img",
                             str(IMG), "--frames", "8", "--batch", "4", "--epochs", "2",
                             "--classes", "3", "--ckpt-dir", os.path.join(tmp, "ckpt")])
            torch.cuda.synchronize()
            used = delta(launches(), before)
        finally:
            tempfile.tempdir = saved_tmp
            restore_modes()
    print(f"classifier example: launches {used}")
    print(f"classifier example: eval accuracy by epoch {r.eval_acc}, last loss {r.loss:.4f}, "
          f"loader {r.clips_per_s:.1f} clips/s, resume parity {r.resume_diff:.2e}")
    check(np.isfinite(r.loss), "classifier example: non-finite loss")
    check(r.resume_diff == 0.0, f"classifier example: resume parity {r.resume_diff:.3e}, not 0")
    for name in ("fused_add_norm", "mixer_fused", "mixer_bwd"):
        check(used[name] > 0, f"classifier example: {name} not launched")
    check(not dist.is_initialized(), "classifier example: left its process group")
    torch.cuda.empty_cache()


def phase_profiling_utils(device):
    """Phase J: ``profiling.trace`` around Base fp32 forwards, two of them
    in ``annotate`` ranges (the Chrome trace's CUDA kernels launched inside
    those ranges, matched to their launches by correlation id: K2's row
    kernel 25 and K3's output walk 24 a forward, as the counters say); ``StepTimer``'s median against
    CUDA-event time (within 10 %); ``device_memory_summary`` against
    ``torch.cuda.memory_stats``; ``MetricLogger.log_every``'s memory
    column."""
    import logging

    from videomamba_tpu_torch.utils.basic_utils import MetricLogger
    from videomamba_tpu_torch.utils.profiling import (
        StepTimer,
        annotate,
        device_memory_summary,
        trace,
    )

    model = videomamba_base(pool_type="avg", device=device,
                            generator=torch.Generator().manual_seed(47)).eval()
    clip = torch.randn((1, 3, 8, IMG, IMG), generator=torch.Generator().manual_seed(48)).to(device)
    with torch.inference_mode(), tempfile.TemporaryDirectory(dir=build_dir()) as tmp:
        model(clip)
        torch.cuda.synchronize()
        with trace(tmp) as prof:
            model(clip)  # a profiler may miss a window's first kernels: not counted
            torch.cuda.synchronize()
            before = launches()
            for i in range(2):
                with annotate(f"counted_forward_{i}"):
                    model(clip)
            torch.cuda.synchronize()
            used = delta(launches(), before)
        with open(prof.trace_path) as f:
            events = json.load(f)["traceEvents"]
        spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") == "user_annotation"
                 and e.get("name", "").startswith("counted_forward_")]
        launched = {e["args"]["correlation"] for e in events
                    if e.get("cat") == "cuda_runtime" and "Launch" in e.get("name", "")
                    and any(lo <= e["ts"] <= hi for lo, hi in spans)}
        kernels = [e["name"] for e in events
                   if e.get("cat") == "kernel" and e["args"].get("correlation") in launched]
        norms = sum("add_norm_kernel" in k for k in kernels)
        walks = sum("split_output_kernel" in k for k in kernels)
        print(f"profiling.trace: {os.path.getsize(prof.trace_path) / 2**20:.1f} MiB Chrome "
              f"trace; in the two annotated forwards {len(launched)} kernel launches and "
              f"{len(kernels)} CUDA kernels: add_norm_kernel {norms} "
              f"(K2 counter {used['fused_add_norm']}), split_output_kernel {walks} "
              f"(K3 counter {used['mixer_fused']})")
        check(len(spans) == 2 and len(kernels) == len(launched),
              "profiling.trace: the annotated forwards' launches and kernels do not match")
        check(norms == used["fused_add_norm"] == 50 and walks == used["mixer_fused"] == 48,
              "profiling.trace: the trace's K2 / K3 kernels do not match 25 / 24 a forward")

        for _ in range(2):
            model(clip)
        timer = StepTimer()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        events_ms = []
        for _ in range(5):
            timer.reset_clock()
            start.record()
            out = model(clip)
            stop.record()
            timer.tick(out)
            events_ms.append(start.elapsed_time(stop))
        host, dev = timer.meter.median * 1e3, statistics.median(events_ms)
        print(f"StepTimer median {host:.3f} ms, CUDA events {dev:.3f} ms "
              f"({abs(host - dev) / dev:.1%} apart)")
        check(abs(host - dev) <= 0.10 * dev, "StepTimer and CUDA-event times more than 10 % apart")

    summary = device_memory_summary()
    stats = torch.cuda.memory_stats()
    peak = summary["cuda:0"]["peak_mb_in_use"] * 2**20
    print(f"device_memory_summary: {summary['cuda:0']}")
    check(peak == stats["allocated_bytes.all.peak"],
          f"device_memory_summary peak {peak} != memory_stats {stats['allocated_bytes.all.peak']}")

    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    log = logging.getLogger("videomamba_tpu_torch.utils.basic_utils")
    keep, level = Keep(), log.level
    log.addHandler(keep)
    log.setLevel(logging.INFO)
    try:
        metrics = MetricLogger()
        with torch.inference_mode():
            for _ in metrics.log_every(range(3), log_freq=1, header="phase J"):
                metrics.update(pool_norm=torch.linalg.vector_norm(model(clip)[1]))
    finally:
        log.removeHandler(keep)
        log.setLevel(level)
    print(f"MetricLogger.log_every: {lines[0]}")
    check(all("max mem:" in line for line in lines[:-1]), "log_every printed no memory column")
    del model
    torch.cuda.empty_cache()


def phase_seconds(phase, t0: float) -> float:
    """Print a phase's host seconds since ``t0``; returns the time now."""
    now = time.perf_counter()
    print(f"phase {phase}: {now - t0:.1f} s")
    return now


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0] if out else "unknown"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; nothing was run", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())  # name, power limit
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 off (matmul and cuDNN)")

    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")

    with torch.inference_mode():
        kernels = phase_kernels(BASE, device)

        fast, plain = build_models(device)
        clip = torch.randn((1, 3, 8, IMG, IMG), generator=torch.Generator().manual_seed(2)).to(device)
        depth = fast.depth

        zero_launches()
        full_vis = phase_forward(fast, plain, clip, depth)
        phase_stream(fast, clip, full_vis, chunk_frames=4)
        phase_unfused(BASE, device)
        fp32_counts = launches()
        print(f"fp32 main path launches: {fp32_counts}")
        for name in ("selective_scan", "fused_add_norm", "mixer_fused"):
            check(fp32_counts[name] > 0, f"{name} was not launched on the fp32 main path")

        kernels["block_fused"] = phase_bf16_kernels(device)

        bf16 = cast_module_for_compute(copy.deepcopy(fast), torch.bfloat16)
        zero_launches()
        bf16_vis = phase_bf16_forward(bf16, clip, full_vis, depth)
        phase_stream(bf16, clip, bf16_vis, chunk_frames=4, tol=BF16_TOL)
        bf16_counts = launches()
        print(f"bf16 main path launches: {bf16_counts}")
        for name in ("fused_add_norm", "block_fused"):
            check(bf16_counts[name] > 0, f"{name} was not launched on the bf16 main path")

        m1_times = {"fp32": serving_times("fp32", fast, clip, plain),
                    "bf16": serving_times("bf16", bf16, clip)}
        serving_profile("fp32", fast, clip)
        serving_profile("bf16", bf16, clip)

        kernels.update(phase_bwd_kernels(device))
    del fast, plain, bf16
    torch.cuda.empty_cache()

    batch2 = train_batch(2, device, zero_target=False)
    zero_launches()
    sd0, fp32_grads = phase_train_fp32(device, batch2, depth)
    train32_counts = launches()
    print(f"fp32 training main path launches: {train32_counts}")
    for name in ("fused_add_norm", "mixer_fused", "mixer_bwd", "selective_scan_bwd",
                 "fused_add_norm_bwd"):
        check(train32_counts[name] > 0, f"{name} was not launched on the fp32 training path")

    zero_launches()
    model = phase_train_bf16(device, sd0, fp32_grads, batch2, depth)
    batch4 = train_batch(4, device)
    step = make_train_step(model, adamw(model), compute_dtype=torch.bfloat16)
    bf16_ms, bf16_peak = timed_steps(step, batch4, "bf16 train step (4,3,8,224,224)")
    check(all(p.dtype == torch.float32 for p in model.parameters()), "bf16 steps: masters not fp32")
    train16_counts = launches()
    print(f"bf16 training main path launches: {train16_counts}")
    for name in ("fused_add_norm", "mixer_fused", "mixer_bwd"):
        check(train16_counts[name] > 0, f"{name} was not launched on the bf16 training path")
    del model, step
    torch.cuda.empty_cache()

    model = base_model(device, sd0)
    step = make_train_step(model, adamw(model))
    fp32_ms, fp32_peak = timed_steps(step, batch4, "fp32 train step (4,3,8,224,224)")
    print(f"train step B=4: fp32 {fp32_ms:.3f} ms ({fp32_peak:.2f} GiB peak), "
          f"bf16 {bf16_ms:.3f} ms ({bf16_peak:.2f} GiB peak)")
    del model, step
    torch.cuda.empty_cache()

    with torch.inference_mode():
        kernels["block_bwd"] = phase_block_bwd_kernels(device)
        kernels["causal_conv"] = phase_conv_kernels(device)
    torch.cuda.empty_cache()

    zero_launches()
    eval_counts = phase_eval_backward(device, sd0, clip, depth)
    for name in ("block_fused", "block_bwd", "selective_scan", "selective_scan_bwd"):
        check(eval_counts[name] > 0, f"{name} was not launched on the eval backward path")
    torch.cuda.empty_cache()

    zero_launches()
    block_route_counts, blk_ms, blk_peak = phase_train_block_route(device, sd0, batch2, batch4,
                                                                   depth)
    for name in ("block_fused", "block_bwd"):
        check(block_route_counts[name] > 0,
              f"{name} was not launched on the whole-block training path")
    print(f"bf16 train step B=4: mixer route {bf16_ms:.3f} ms ({bf16_peak:.2f} GiB peak), "
          f"whole-block route {blk_ms:.3f} ms ({blk_peak:.2f} GiB peak)")

    clip5 = torch.randn((1, 3, 5, IMG, IMG),
                        generator=torch.Generator().manual_seed(21)).to(device)
    decode_counts = {name: 0 for name in WRAPPERS}
    with torch.inference_mode():
        fast = base_model(device, sd0).eval()
        for label, model, tol, ktol in (("fp32", fast, MODEL_TOL, KERNEL_TOL),
                                        ("bf16", None, BF16_MODEL_TOL, BF16_TOL)):
            if model is None:
                model = cast_module_for_compute(fast, torch.bfloat16)
            zero_launches()
            used, entry = phase_decode(model, label, clip5, tol, ktol, depth)
            decode_counts = {k: decode_counts[k] + used[k] for k in used}
            kernels.setdefault("decode_stack", entry)
        del fast, model
    check(decode_counts["decode_stack"] > 0, "decode_stack was not launched on the decode path")
    torch.cuda.empty_cache()

    zero_launches()
    conv_counts = phase_conv_path(device)
    torch.cuda.empty_cache()

    m2, m2_plain = build_m2_models(device)  # outside inference mode: phase 18 differentiates it
    with torch.inference_mode():
        kernels.update(phase_ssd_kernels(device))
        zero_launches()
        m2_vis = phase_m2_forward(m2, m2_plain, clip, depth)
        phase_stream(m2, clip, m2_vis, chunk_frames=4)
        m2_fp32_counts = launches()
        print(f"m2 fp32 main path launches: {m2_fp32_counts}")
        for name in ("fused_add_norm", "ssd_pmixer", "ssd_mixer"):
            check(m2_fp32_counts[name] > 0, f"{name} was not launched on the m2 fp32 path")
    with torch.inference_mode():
        m2_bf16 = cast_module_for_compute(copy.deepcopy(m2), torch.bfloat16)
        zero_launches()
        m2_bf16_vis = phase_m2_bf16_forward(m2_bf16, clip, m2_vis, depth)
        phase_stream(m2_bf16, clip, m2_bf16_vis, chunk_frames=4, tol=BF16_TOL)
        m2_bf16_counts = launches()
        print(f"m2 bf16 main path launches: {m2_bf16_counts}")
        for name in ("fused_add_norm", "ssd_pmixer"):
            check(m2_bf16_counts[name] > 0, f"{name} was not launched on the m2 bf16 path")
        m2_times = {"fp32": serving_times("m2 fp32", m2, clip, m2_plain,
                                          {"VIDEOMAMBA_SSD_METHOD": "chunked"}),
                    "bf16": serving_times("m2 bf16", m2_bf16, clip)}
        serving_profile("m2 fp32", m2, clip)
        serving_profile("m2 bf16", m2_bf16, clip)
        for tag in ("fp32", "bf16"):
            print(f"serving host ms, {tag}, full clip / first chunk / continuation: "
                  f"Mamba-1 Base {' / '.join(f'{t:.3f}' for t in m1_times[tag])}, "
                  f"Mamba-2 Base {' / '.join(f'{t:.3f}' for t in m2_times[tag])}")
        del m2_plain
        m2_decode_counts = {name: 0 for name in WRAPPERS}
        for label, model, tol, ktol in (("m2 fp32", m2, MODEL_TOL, KERNEL_TOL),
                                        ("m2 bf16", m2_bf16, BF16_MODEL_TOL, BF16_TOL)):
            zero_launches()
            used, entry = phase_decode(model, label, clip5, tol, ktol, depth, wide_steps=8)
            m2_decode_counts = {k: m2_decode_counts[k] + used[k] for k in used}
            kernels.setdefault("decode_stack_m2", entry)
        del m2, m2_bf16, model
    check(m2_decode_counts["decode_stack_m2"] > 0,
          "decode_stack_m2 was not launched on the m2 decode path")
    torch.cuda.empty_cache()

    with torch.inference_mode():
        kernels.update(phase_ssd_train_kernels(device))
    torch.cuda.empty_cache()
    zero_launches()
    m2_train_times = phase_m2_train(device, depth)
    m2_train_counts = launches()
    print(f"m2 training main path launches: {m2_train_counts}")
    for name in ("fused_add_norm", "ssd_mixer", "ssd_mixer_bwd", "ssd_pmixer",
                 "ssd_pmixer_bwd", "ssd_scan_bwd"):
        check(m2_train_counts[name] > 0, f"{name} was not launched on the m2 training path")
    print("m2 train step B=4: " + ", ".join(
        f"{tag} {ms:.3f} ms ({peak:.2f} GiB peak)" for tag, (ms, peak) in m2_train_times.items())
          + f"; Mamba-1 mixer route fp32 {fp32_ms:.3f} ms, bf16 {bf16_ms:.3f} ms")
    zero_launches()
    ssd_path_counts = phase_ssd_chunked_path(device)
    torch.cuda.empty_cache()
    with torch.inference_mode():
        phase_state_sizes(device)
    torch.cuda.empty_cache()
    zero_launches()
    gate_counts = phase_repaired_gates(device)
    torch.cuda.empty_cache()

    t_new = time.perf_counter()
    zero_launches()
    with torch.inference_mode():
        phase_masked_serving(device, sd0, depth)
    masked_serving_counts = launches()
    t_new = phase_seconds(26, t_new)
    print(f"masked serving path launches: {masked_serving_counts}")
    for name in ("fused_add_norm", "mixer_fused", "block_fused", "ssd_pmixer"):
        check(masked_serving_counts[name] > 0, f"{name} was not launched on the masked serving path")
    zero_launches()
    phase_masked_train(device, sd0, depth, {"fp32": (fp32_ms, fp32_peak),
                                            "bf16": (bf16_ms, bf16_peak)})
    masked_train_counts = launches()
    print(f"masked training path launches: {masked_train_counts}")
    for name in ("fused_add_norm", "mixer_fused", "mixer_bwd"):
        check(masked_train_counts[name] > 0, f"{name} was not launched on the masked training path")
    t_new = phase_seconds(27, t_new)
    zero_launches()
    phase_from_files(device, sd0, depth)
    files_counts = launches()
    for name in ("fused_add_norm", "mixer_fused", "mixer_bwd"):
        check(files_counts[name] > 0, f"{name} was not launched on the clip-file path")
    t_new = phase_seconds(28, t_new)
    zero_launches()
    with torch.inference_mode():
        phase_refiner(device, full_vis.reshape(1, 8, -1, BASE["embed"]))
    refiner_counts = launches()
    print(f"refiner path launches: {refiner_counts}")
    for name in ("fused_add_norm", "mixer_fused", "block_fused"):
        check(refiner_counts[name] > 0, f"{name} was not launched on the refiner path")
    t_new = phase_seconds(29, t_new)
    rendezvous = init_nccl_world()
    try:
        sp_counts = phase_sequence_parallel(device)
        torch.cuda.empty_cache()
        t_new = phase_seconds("A", t_new)
        tp_counts = phase_tensor_parallel(device)
        torch.cuda.empty_cache()
        t_new = phase_seconds("B", t_new)
        sharded_counts = phase_sharded_train(device, sd0, depth, {"fp32": (fp32_ms, fp32_peak),
                                                                  "bf16": (bf16_ms, bf16_peak)})
        print(f"sharded training path launches: {sharded_counts}")
        t_new = phase_seconds("C", t_new)
    finally:
        dist.destroy_process_group()
        os.remove(rendezvous)
    for label, used, names in (
            ("sequence-parallel", sp_counts, ("fused_add_norm", "selective_scan",
                                              "selective_scan_bwd", "ssd_scan", "ssd_scan_bwd")),
            ("tensor-parallel", tp_counts, ("selective_scan", "selective_scan_bwd")),
            ("sharded training", sharded_counts, ("fused_add_norm", "mixer_fused", "mixer_bwd"))):
        for name in names:
            check(used[name] > 0, f"{name} was not launched on the {label} path")
    zero_launches()
    phase_files_and_determinism(device, sd0, full_vis, clip, depth)  # sets, then restores, modes
    files_det_counts = launches()
    for name in ("fused_add_norm", "mixer_fused", "mixer_bwd"):
        check(files_det_counts[name] > 0,
              f"{name} was not launched on the checkpoint and determinism path")
    t_new = phase_seconds(30, t_new)

    surface_counts = {}
    for phase, fn, names, under_inference in (
            ("D", phase_ops_surface, ("selective_scan",), True),
            ("E", phase_streaming_cli, ("mixer_fused", "mixer_bwd"), False),
            ("F", phase_checkpoint_cli, ("fused_add_norm", "mixer_fused"), False),
            ("G", phase_serving_example, ("fused_add_norm", "block_fused", "ssd_pmixer",
                                          "mixer_fused"), False),
            ("H", phase_masked_example, ("fused_add_norm", "mixer_fused", "mixer_bwd"), False),
            ("I", phase_classifier_example, ("fused_add_norm", "mixer_fused", "mixer_bwd"),
             False),
            ("J", phase_profiling_utils, ("fused_add_norm", "mixer_fused"), False)):
        zero_launches()
        with torch.inference_mode() if under_inference else contextlib.nullcontext():
            result = fn(device)
        surface_counts[phase] = launches()
        print(f"phase {phase} launches: {surface_counts[phase]}")
        for name in names:
            check(surface_counts[phase][name] > 0, f"{name} was not launched in phase {phase}")
        if phase == "G":
            print("serving example, median host ms of chunks 2-4 and frames/s, 64-frame Base "
                  "chunks: " + ", ".join(f"{tag} {ms:.3f} ms ({fps:.1f} frames/s)"
                                         for tag, (ms, fps) in result.items()))
        t_new = phase_seconds(phase, t_new)

    paths = (fp32_counts, bf16_counts, train32_counts, train16_counts, eval_counts,
             block_route_counts, decode_counts, conv_counts, m2_fp32_counts, m2_bf16_counts,
             m2_decode_counts, m2_train_counts, ssd_path_counts, gate_counts,
             masked_serving_counts, masked_train_counts, files_counts, refiner_counts,
             sp_counts, tp_counts, sharded_counts, files_det_counts,
             *surface_counts.values())
    counts = {name: sum(c[name] for c in paths) for name in WRAPPERS}

    rows = [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": counts[name], **kernels[name]}
        for name in WRAPPERS
    ]
    print(f"chip_smoke total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
