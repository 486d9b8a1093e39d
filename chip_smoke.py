#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``unetsulc_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU (H100):

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``unetsulc_tpu_torch/csrc`` and, in
order (each phase aborts the script with a non-zero exit on failure):

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the kernels with ``nvcc`` for sm_90a, printing the seconds;
3. holds kernel A (``conv3x3x3_fwd``) against its plain PyTorch version
   at three flagship shapes, a narrow one, one with channel tails and a
   deep one (6 x 7 x 320: one-dy runs): y within 1 bf16 ulp (rtol 2^-7,
   atol 1e-3 — both sum exact bf16 products in f32, in another order),
   stat sums rtol 1e-3, the ring exactly 0, and two launches on the same
   inputs bit-equal;
4. holds kernel B (``max_pool_buf_fwd``) against its plain version at
   three flagship levels and one with a channel tail, with and without an
   affine: bit-equal;
5. drives the labelling path end to end: three synthetic graphs in the
   96^3 bucket, a random-init flagship model (in 1, init 64, 63 classes,
   bf16) saved as ``.mdsm``, ``unetsulc_tpu_torch.label.main`` on the
   card with the launch counts zeroed just before and read just after;
   then the same forward through the plain versions on the card;
6. holds every kernel launch of one flagship forward (recorded inputs)
   against its plain version at the tolerances of phases 3 and 4, and
   times it against its plain version and one PyTorch library call,
   beside the least time the card could take (its bound): each call is
   captured as a CUDA graph and replayed back to back between CUDA events,
   in turns; then kernel A's share of its bound by level;
7. profiles one flagship forward: device time by kernel, the device's
   busy share, peak device memory;
8. holds the backward kernels against their plain versions at the four
   flagship levels, one shape with channel tails, one at the edges of
   kernels C and D's tiles (13 x 49 x 49, 96+160->48) and two with deep Z
   (200, 240: D's shorter steps, C's one-dy runs; 6 x 7 x 320, a volume
   rounded up past the largest bucket: D's one run per dy): kernel C
   (``conv3x3x3_dx``) |k - p| <= 2^-7 |p| + 1e-3 max|p| with its sums at
   rtol 1e-3, atol 1e-3 max|p| and a zero ring; kernel D
   (``conv3x3x3_wgrad``) rtol 1e-3, atol 1e-3 max|p|; kernel E
   (``max_pool_buf_bwd``) dx bit-equal, d(affine) rtol 1e-3, atol 1e-3
   max|p| (gradients are small, so every atol is relative to the largest
   magnitude of the tensor), at three flagship levels and 9 x 8 x 11 x 12,
   with and without an affine, on random inputs and on a buffer quantized
   to 0, 0.5 and 1 (ties), and at 96^3 and 9 x 8 x 11 also through its C
   entry point into NaN-filled dx, d(affine) and workspace (an element the
   kernel does not write shows); two launches of C, of D and of E on the
   same inputs bit-equal;
9. drives the training step of the flagship model (seed 0) on
   ``bench.py``'s batch (numpy seed 0, 2% of 96^3 voxels occupied, labels
   0..62 there, -1 elsewhere), SGD lr 0.01, momentum 0.9, through
   ``make_train_step``: one step against the plain step on the card from
   the initial state and again after 100 steps (loss within 1%, all
   parameters' gradients together at cosine >= 0.98, each parameter's at
   cosine >= 0.9 and max error <= 50% of its max |g|: bf16 gradients are
   noisy, and two kernel steps from one state differ by more than 0.99 /
   5%), with the spread of two kernel steps and
   both bf16 steps' distance from an f32 step printed at the initial
   state; launches per step (counts zeroed just before), in a step that
   runs with host syncs turned into errors; 3 warm-up and 20 timed steps
   (losses kept on the device, one fetch); a falling loss;
   a profile of one step; and a ``training_layers=["final_conv"]`` step
   that launches no backward kernel and leaves the trunk bit-identical;
10. holds every launch of kernels C, D and E in one training step
   (recorded inputs) against its plain version at phase 8's tolerances,
   and two launches of C and of D bit-equal, and times it as phase 6
   does, against one library call (``aten.convolution_backward`` in bf16,
   channels-last, for C and D; ``max_pool3d_with_indices_backward`` for
   E) and its bound, printing its share of the bound (and C's, D's and
   E's by level; beside each E launch, a plain ``copy_`` of its input x,
   the card's streaming rate on nearly E's bytes); D's library call is
   also timed on the batch-stride-C view that earlier versions of phases
   10 and 18 gave it (PERF.md §7);
12. holds the four GroupNorm kernels (``gn_stats``, ``gn_apply``,
   ``gn_bwd_reduce``, ``gn_bwd_dx``) against their plain versions at the 14
   GroupNorms of the flagship non-fused forward (bf16, G 32), one in f32
   and one with N 2, odd extents and 36 channels: mean and inv rtol 1e-4,
   apply within 1 bf16 ulp, reduce rtol 1e-3 with atol 1e-3 max|p|, dx as
   kernel C; and each of the four bit-identical in two runs at 96^3 x 64;
13. drives labelling on the non-fused path end to end: a random flagship
   model with the transposed-conv decoder (``interpolate=False``) saved as
   ``.mdsm``, ``label.main`` on phase 5's graphs with the launch counts
   zeroed (gn_stats and gn_apply 14 per graph, no launch of kernels A-E),
   label latency, the forward against the same forward with the plain
   GroupNorm (phase 5's bars), forward time, and a profile;
14. trains that model on phase 9's batch: the step against the plain step
   at phase 9's bars, launches per step (each GroupNorm kernel 14), 3
   warm-up and 20 timed steps, a falling loss, peak memory, a profile of
   one step, and one step with dropout 0.1 at batch 2;
15. holds every GroupNorm launch of one non-fused training step (recorded
   inputs) against its plain version and times it as phase 6 does,
   against one library call (``F.group_norm`` on a contiguous
   channels-first copy of x, and also on the channels-first view of its
   channels-last memory; ``aten.native_group_norm_backward``) and its
   bound (bytes / 3.35 TB/s), then prints, for each of the 14 GroupNorm
   layers, each GroupNorm kernel's time, bound and share of the bound, and
   the ticket memset of gn_stats and gn_bwd_reduce timed alone;
16. holds kernels A, C and D in their spatial-parallel halo modes against
   their plain versions at the flagship's slab shapes: level 0 at space 2
   (48 x 96 x 96 slabs; 32->64, 32->32 and the decoder's 64+128->64; an
   edge shard's valid pattern on each side and an interior one) and the
   slab+E layout of level 1 at space 4 (13 planes of 49 x 49, odd Xp 15,
   valid_out on the last and an inner shard, and a tile-edge case of
   96+160->48 channels), at phases 3 and 8's bars, with two launches of A,
   of C and of D bit-equal;
17. drives the spatial-parallel training step
   (``parallel.make_mesh(space=n, devices=[cuda] * n)``,
   ``make_train_step_sp``) of the flagship on phase 9's batch at space 2
   and 4, all shards on this one card, one after another (so its time is
   not a scaling figure): the step against the single-device step from
   the same state at phase 9's bars; launches per step (counts zeroed just
   before) against the counts PERF.md predicts; 3 warm-up and 20 timed
   steps; a falling loss; peak memory beside the single-device step's,
   measured the same way from the same state; a profile of one step; one
   ``make_eval_step_sp`` call;
18. holds every halo-mode launch of one space-2 sp step (recorded inputs)
   against its plain version (and two launches of C and of D bit-equal)
   and times it against the same launch without halo, its plain version,
   one library call on the halo-filled slab (cuDNN ``conv3d`` with
   padding (0, 1, 1); ``aten.convolution_backward`` with that padding)
   and its bound, printing its share of the bound, and A's, C's and D's
   by level;
19. holds the three probe kernels (``mxu_dot``, ``mxu_rdot``,
   ``slab_build``; ``csrc/mxu_probe.cu``) against their plain versions at
   the JAX probe's shapes (ps 10976, 200 reps, its 11 + 6 + 6
   combinations): o exactly equal, and for the build the whole final slab;
   two launches of each dot and rdot combination bit-equal;
20. runs the probe CLI (``unetsulc_tpu_torch.tools.mxu_probe.main([])``)
   with the launch counts zeroed just before (11 / 6 / 6), then times every
   probe launch against its plain version, ``torch.matmul`` on the same
   bf16 operands (200 calls; none for the build) and its bound (each dot
   launch also at its steady rate: the time of its last 100 reps, from a
   launch of 100), failing any launch above 105% of its bound (work left
   out), and prints the dot's share of its bound at n = 64 and at
   n >= 128, and the dot's and rdot's sums against ``torch.matmul``'s;
21. runs the training CLI end to end in process
   (``unetsulc_tpu_torch.main.main(["-p", ...])``): a 3-fold CV experiment
   of the flagship (init 64, bf16, batch 1, 2 epochs, lr 0.01, momentum
   0.9, thresholds 20 and 50, ``cuda`` 0) on six synthetic 96^3 graphs,
   then a transfer experiment from its cv0 model; each checked for the
   artifact tree, the results schema, finite and falling losses, the
   launches (per epoch phase, printed: kernels A-E in the CV experiment;
   A-D in the transfer one, whose fold 0 trains final_conv only and
   launches no backward kernel, and whose fine-tuned decoders sit above
   every pool), no plain version on a CUDA tensor, and the volumes used;
   seconds per epoch and voxels/s printed;
22. data and fold parallelism on this one card: the data-parallel train
   step (``make_mesh(data=2, devices=[cuda] * 2)``, ``shard_batch``,
   ``make_train_step_dp``) of the flagship at batch 2 (bench.py's volume
   and one from numpy seed 1) against the single-device step at batch 2
   from the same state, two steps: bit-equal (each row runs the
   single-device step's per-volume operations in its order), else the
   differing parameter printed and loss rtol 1e-6, each parameter within
   1e-3 max|p|; launches per step (counts zeroed just before) twice phase
   9's per volume; no plain version on a CUDA tensor; ms/step and peak
   memory of both (3 warm-up and 20 timed steps: the one-process
   design's overhead, not a scaling figure); the dp eval step against the
   single-device eval step; then phase 21's CV experiment again with
   ``tpu.fold_parallel: 2`` (``run_experiment(..., devices=[cuda] * 2)``:
   two fold threads on this card), every non-timing results key and the
   launches in all equal to phase 21's, main()'s wall time beside it;
   then phase 21's train phase in parts (fold 0, two epochs, host spans
   handed to each train phase's ``_epoch_pass``): the prefetch thread's
   batch making (within it the dataset's parts: loading the cached
   points, augmentation, label ids, voxelization; the rest is the bucket
   copy), pinning and upload, the main thread's waits, step dispatch and
   end-of-phase fetch, the device's busy share under the profiler, and
   the voxelizer alone on the same volumes, native against numpy
   (bit-equal), ms per volume;
23. the spatially sharded non-fused path on this one card: the sharded
   GroupNorm's kernel modes (``gn_stats_sums``, ``gn_finalize``,
   ``gn_bwd_dx`` with another count, ``gn_bwd_dx_denom``) against their
   plain versions at the flagship's space-2 shard slabs in bf16 and f32,
   and ``group_norm_sharded`` forward and backward against the
   single-device GroupNorm kernels (f32, rtol 1e-5); the sharded non-fused
   train step (``make_train_step_sp_halo``, ``[cuda] * n`` shards) of phase
   14's model on phase 9's batch at space 2 and 3 against the
   single-device non-fused step at phase 9's bars, its GroupNorm launches
   per step (counts zeroed just before) against the partition's, no plain
   version on a CUDA tensor, 3 warm-up and 10 timed steps of each beside
   the single-device step, peak memory, a falling loss, a profile of one
   sharded step, the sharded eval step; one f32 step at space 2 of the 'crg' interpolating flagship; and
   ``graft_entry.dryrun_multichip(2)``; then every launch of the new modes
   in one space-2 step timed against its plain version and its bound;
24. the pattern classifier at full width (``PatternCNN3D`` (16, 32, 64),
   f32, a 96^3 box, batch 4, ``PatternDataset`` on synthetic graphs of
   extent 90): its GroupNorm launches per Adam step (counts zeroed just
   before: one of each kernel per layer, C 8 to 64), each held to its plain
   version at phase 12's bars and timed; the step twice from one state
   (bit-equal) and against the plain step (loss rtol 1e-5, gradients at
   phase 9's bars); 3 + 10 timed steps, peak memory; then
   ``train_pattern_classifier`` (30 epochs, lr 3e-3): a falling loss, best
   eval accuracy >= 0.9, its launches. Then ``remat`` on the fused step
   (phase 9's batch), phase 14's non-fused step and a space-2 sp step: each
   bit-equal with and without remat (loss, counts, gradients, the updated
   parameters), forward kernels launched twice as often, the others as
   often; the fused step with and without remat timed in turns, peak
   memory;
25. prints the kernels' JSON line, the card line, and the final JSON line.

It exits non-zero without a result when CUDA is not available. Scratch
files go under ``build/chip_smoke/``.
"""

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
N_GRAPHS = 3
LABELS = [f"S.{i:02d}._left" for i in range(62)] + ["unknown"]
# bf16 forward against its plain version, as a share of the largest |logit|
# (a few bf16 ulps at the largest logit)
LOGIT_TOL = 0.02
# graph replays between one pair of CUDA events, per timed turn
REPS = 10
# the flagship training step (bench.py:30-45)
VOLUME = (96, 96, 96)
CLASSES = 63
TRAIN_LR = 0.01
WARMUP, STEPS = 3, 20
# a step against the plain step on the card. bf16 gradients of this step
# are noisy: a kernel step and the plain step sum in different orders, and
# the f32 differences flip bf16 roundings and ReLU gates that the deep
# encoder amplifies, per parameter up to cosine 0.97 and max |dg| / max |g|
# 0.3 at init; each bf16 step is further still from an f32 step (PERF.md,
# "Training step"). So the loss is held to 1%, all parameters' gradients
# together to cosine 0.98, and each parameter's to cosine 0.9 and max |dg|
# <= 50% of its max |g|: bars a wrong kernel, branch or layout breaks, and
# the noise does not. Two kernel steps from one state must agree bit for
# bit: the kernels add their partial sums in a fixed order.
LOSS_RTOL, GLOBAL_COS, GRAD_COS, GRAD_ERR = 0.01, 0.98, 0.9, 0.5
# the trained state of the second comparison, in steps from the initial one
TRAINED_STEPS = 100


def fail(msg):
    # on both streams: a caller that keeps only the end of one still sees it
    print(f"FAILED: {msg}", flush=True)
    print(f"chip_smoke.py FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def sync():
    torch.cuda.synchronize()


def capture(fn):
    """One call of ``fn`` captured as a CUDA graph, after a warm-up call on
    a side stream. Replaying the graph runs the call's device work without
    its host-side launch cost, so back-to-back replays time the device."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def event_ms(graph, reps):
    """Device time of one replay of ``graph`` in ms: ``reps`` replays back
    to back between one pair of CUDA events."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def timed_row(name, shape, kern, plain, lib, bound, err):
    """One launch's row: ``kern``, ``plain`` and ``lib`` each captured as
    a CUDA graph and timed in turns (plain, kernel, library, kernel; three
    times), medians in ms, beside the bound and the max abs error. ``lib``
    None: no PyTorch call computes the function (``library_ms`` None)."""
    gk, gp = capture(kern), capture(plain)
    gl = None if lib is None else capture(lib)
    sync()
    ms_k, ms_p, ms_l = [], [], []
    for _ in range(3):
        ms_p.append(event_ms(gp, REPS))
        ms_k.append(event_ms(gk, REPS))
        if gl is not None:
            ms_l.append(event_ms(gl, REPS))
        ms_k.append(event_ms(gk, REPS))
    del gk, gp, gl
    row = dict(shape=shape, ms=statistics.median(ms_k),
               plain_ms=statistics.median(ms_p),
               library_ms=statistics.median(ms_l) if ms_l else None,
               bound_ms=bound, max_abs_err=err)
    lib_txt = ("none" if row["library_ms"] is None
               else f"{row['library_ms']:.4f} ms")
    print(f"  {name} {shape}: kernel {row['ms']:.4f} ms "
          f"({bound / row['ms'] * 100:.1f}% of its bound), plain "
          f"{row['plain_ms']:.4f} ms, library {lib_txt}, bound "
          f"{bound:.4f} ms, max|err| {err:.3g}", flush=True)
    return row


def level_shares(name, rows):
    """Print a kernel's rows summed by level (the extent after '@' in each
    row's shape): device time, share of the bound, library time."""
    levels = {}
    for r in rows:
        levels.setdefault(r["shape"].split("@")[1], []).append(r)
    for ext, rs in levels.items():
        ms = sum(r["ms"] for r in rs)
        bound = sum(r["bound_ms"] for r in rs)
        lib = sum(r["library_ms"] for r in rs)
        print(f"  {name} at {ext}: {len(rs)} launches, {ms:.4f} ms, "
              f"{bound / ms * 100:.1f}% of its bound ({bound:.4f} ms), "
              f"library {lib:.4f} ms", flush=True)


def graph_ms(fn):
    """Device time of one call of ``fn`` in ms, as timed_row times each of
    its calls (a CUDA graph replayed REPS times between CUDA events; the
    median of three turns)."""
    graph = capture(fn)
    sync()
    ms = statistics.median(event_ms(graph, REPS) for _ in range(3))
    del graph
    return ms


def bit_equal(out_a, out_b):
    """Whether two launches' outputs (tensors or tuples of them) agree bit
    for bit."""
    if isinstance(out_a, torch.Tensor):
        out_a, out_b = (out_a,), (out_b,)
    return all(torch.equal(a, b) for a, b in zip(out_a, out_b))


def rand_buffer(g, c, gen, dev):
    """bf16 post-ReLU-like buffer with an exact-zero ring."""
    from unetsulc_tpu_torch.ops import conv_fused as cf

    x = torch.relu(torch.randn((g.X, g.Y, g.Z, c), generator=gen, device=dev))
    return cf.pad_to_geom(x[None].to(torch.bfloat16), g).contiguous()


def rand_affine(c, gen, dev):
    a = 0.5 + torch.rand(c, generator=gen, device=dev)
    b = 0.2 * torch.randn(c, generator=gen, device=dev)
    return torch.stack([a, b])


def ring_is_zero(buf):
    inner = torch.zeros(buf.shape[:3], dtype=torch.bool, device=buf.device)
    inner[1:-1, 1:-1, 1:-1] = True
    return bool((buf[~inner] == 0).all())


# ---------------------------------------------------------------------------
# bounds and library yardsticks
# ---------------------------------------------------------------------------


# A bound counts the bytes the function must move: each input's interior
# read once (its ring is known to be zero and is never read), each output
# written once with its ring.


def conv_bound(xs, cout):
    xp, yp, zp = xs[0].shape[:3]
    cin = sum(int(x.shape[3]) for x in xs)
    vox = (xp - 2) * (yp - 2) * (zp - 2)
    flops = 2.0 * vox * 27 * cin * cout
    nbytes = 2.0 * (vox * cin + xp * yp * zp * cout) + 2.0 * 27 * cin * cout \
        + 4.0 * (2 * cin + 3 * cout)
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3, flops, nbytes


def pool_bound(buf):
    xp, yp, zp, c = buf.shape
    vox = (xp - 2) * (yp - 2) * (zp - 2)
    ox, oy, oz = (xp - 2) // 2 + 3, (yp - 2) // 2 + 3, (zp - 2) // 2 + 3
    nbytes = 2.0 * c * (vox + ox * oy * oz) + 8.0 * c
    ops = 3.0 * vox * c  # affine (2) + one max per input value
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3


def conv_library_call(xs, affs, weight, bias, g):
    """cuDNN conv3d in bf16, channels_last_3d, on the pre-normalized
    concatenated input (a yardstick; the port never calls it)."""
    from unetsulc_tpu_torch.ops import conv_fused as cf

    mask = cf.interior_mask(g, xs[0].device)
    norm = [torch.where(mask, cf.apply_affine(x, a), 0) for x, a in zip(xs, affs)]
    xn = torch.cat(norm, -1).permute(3, 0, 1, 2)[None]  # channels-last view
    w = weight.to(xn.dtype).contiguous(memory_format=torch.channels_last_3d)
    b = bias.to(xn.dtype)
    return lambda: F.conv3d(xn, w, b)


def pool_library_call(buf, aff, g):
    from unetsulc_tpu_torch.ops import conv_fused as cf

    v = torch.where(cf.interior_mask(g, buf.device), cf.apply_affine(buf, aff),
                    float("-inf"))
    v5 = v.permute(3, 0, 1, 2)[None]  # channels-last view
    return lambda: F.max_pool3d(v5, 2, 2)


def dx_bound(dconv, x):
    """Kernel C: the FLOP of its branch's forward conv; reads dconv's and
    x's interiors and the weights, writes dx with its ring."""
    xp, yp, zp, cout = dconv.shape
    cin = int(x.shape[3])
    vox = (xp - 2) * (yp - 2) * (zp - 2)
    flops = 2.0 * vox * 27 * cin * cout
    nbytes = 2.0 * (vox * (cout + cin) + xp * yp * zp * cin) \
        + 2.0 * 27 * cin * cout + 4.0 * 4 * cin
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3


def wgrad_bound(x, dconv):
    """Kernel D: the FLOP of its branch's forward conv; reads x's and
    dconv's interiors, writes the f32 dW."""
    xp, yp, zp, cin = x.shape
    cout = int(dconv.shape[3])
    vox = (xp - 2) * (yp - 2) * (zp - 2)
    flops = 2.0 * vox * 27 * cin * cout
    nbytes = 2.0 * vox * (cin + cout) + 4.0 * 27 * cin * cout + 8.0 * cin
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3


def pool_bwd_bound(buf):
    """Kernel E: reads x's interior and the pooled output's and
    cotangent's interiors, writes dx with its ring; 6 operations per
    input value (affine 2, compare, scale, two sums)."""
    xp, yp, zp, c = buf.shape
    vox = (xp - 2) * (yp - 2) * (zp - 2)
    ovox = ((xp - 2) // 2 + 1) * ((yp - 2) // 2 + 1) * ((zp - 2) // 2 + 1)
    nbytes = 2.0 * c * (vox + 2 * ovox + xp * yp * zp) + 16.0 * c
    ops = 6.0 * vox * c
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3


def channels_last_5d(t4, batch_stride_c=False):
    """An (X, Y, Z, C) tensor as the (1, C, X, Y, Z) channels-last input of
    a library conv: a contiguous copy with torch.channels_last_3d strides.
    With ``batch_stride_c``, the view ``permute(3, 0, 1, 2)[None]`` that
    earlier versions of phases 10 and 18 used instead: its batch stride is
    C, so PyTorch does not take it for channels-last, and for dW
    (``convolution_backward`` with output_mask [False, True, False]) it
    copies both operands to NCDHW, which cuDNN then transposes back
    (PERF.md §7); dx and the forward conv were not affected."""
    t4 = t4.contiguous()
    return t4.permute(3, 0, 1, 2)[None] if batch_stride_c else \
        t4[None].permute(0, 4, 1, 2, 3)


def conv_bwd_library_call(x, aff, dconv, weight_b, g, output_mask,
                          batch_stride_c=False):
    """cuDNN's conv3d backward (``aten.convolution_backward``) in bf16,
    channels-last, on the pre-normalized input: dx for output_mask
    [True, False, False], dW for [False, True, False] (a yardstick; the
    port never calls it). ``batch_stride_c``: see channels_last_5d."""
    from unetsulc_tpu_torch.ops import conv_fused as cf

    xn = torch.where(cf.interior_mask(g, x.device), cf.apply_affine(x, aff), 0)
    inp = channels_last_5d(cf.unpad_from_geom(xn, g)[0], batch_stride_c)
    go = channels_last_5d(cf.unpad_from_geom(dconv, g)[0], batch_stride_c)
    w = weight_b.to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last_3d)
    return lambda: torch.ops.aten.convolution_backward(
        go, inp, w, None, [1, 1, 1], [1, 1, 1], [1, 1, 1], False, [0, 0, 0],
        1, output_mask)


def pool_bwd_library_call(buf, aff, cot, g):
    """``aten.max_pool3d_with_indices_backward`` on the -inf-padded
    normalized buffer, channels-last (a yardstick)."""
    from unetsulc_tpu_torch.ops import conv_fused as cf

    v = torch.where(cf.interior_mask(g, buf.device), cf.apply_affine(buf, aff),
                    float("-inf"))
    v5 = v.permute(3, 0, 1, 2)[None]  # channels-last view
    _, idx = torch.ops.aten.max_pool3d_with_indices(v5, [2, 2, 2], [2, 2, 2])
    go = cf.unpad_from_geom(cot, cf.pool_geom(g))[0].contiguous().permute(
        3, 0, 1, 2)[None]
    return lambda: torch.ops.aten.max_pool3d_with_indices_backward(
        go, v5, [2, 2, 2], [2, 2, 2], [0, 0, 0], [1, 1, 1], False, idx)


def check_grad(k, p, rtol, what):
    """|k - p| <= rtol |p| + 1e-3 max|p|: gradients are small, so the
    absolute part is relative to the tensor's largest magnitude."""
    atol = 1e-3 * p.abs().max().item()
    torch.testing.assert_close(k.float(), p.float(), rtol=rtol, atol=atol,
                               msg=lambda m: f"{what}: {m}")
    return (k.float() - p.float()).abs().max().item()


def check_dx(out_k, out_p, what):
    """Kernel C against its plain version: dx, sums, ring."""
    (dk, sk), (dp, sp) = out_k, out_p
    err = check_grad(dk, dp, 2 ** -7, f"kernel C dx ({what})")
    check_grad(sk, sp, 1e-3, f"kernel C sums ({what})")
    check(ring_is_zero(dk), f"kernel C ring not zero ({what})")
    return err


def check_pool_bwd(out_k, out_p, what):
    """Kernel E against its plain version: dx bit-equal, d(affine)."""
    (dk, ak), (dp, ap) = out_k, out_p
    check(dk.dtype == dp.dtype and torch.equal(dk, dp),
          f"kernel E dx differs from its plain version ({what})")
    check((ak is None) == (ap is None), f"kernel E d(affine) ({what})")
    if ak is not None:
        check_grad(ak, ap, 1e-3, f"kernel E d(affine) ({what})")
    return 0.0


def rand_grad(g, c, gen, dev, scale=1e-4):
    """bf16 cotangent-like buffer of both signs, small, with a zero ring."""
    from unetsulc_tpu_torch.ops import conv_fused as cf

    d = scale * torch.randn((g.X, g.Y, g.Z, c), generator=gen, device=dev)
    return cf.pad_to_geom(d[None].to(torch.bfloat16), g).contiguous()


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build():
    from unetsulc_tpu_torch import kernels

    t = time.time()
    logs = kernels.build(ptxas_verbose=True)
    for name, log in logs.items():
        # register use, spills and ptxas' notes on serialized wgmmas
        lines = [ln for ln in log.splitlines()
                 if any(w in ln for w in ("registers", "spill", "serialized"))]
        print(f"  {name}: " + " | ".join(ln.strip() for ln in lines))
    print(f"build: {time.time() - t:.1f} s", flush=True)


@torch.no_grad()
def phase_conv_checks(dev):
    from unetsulc_tpu_torch.ops import conv_fused as cf

    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [
        ("enc0.conv2 32->64 @96^3", (96, 96, 96), [32], 64),
        ("dec2.conv1 64+128->64 @96^3", (96, 96, 96), [64, 128], 64),
        ("dec1.conv1 128+256->128 @49^3", (49, 49, 49), [128, 256], 128),
        ("narrow 4->8 @9x8x10", (9, 8, 10), [4], 8),
        # channel counts off the 8-wide vector loads and the 64-wide tile
        ("tails 12+20->10 @7x9x5", (7, 9, 5), [12, 20], 10),
        # a volume rounded up past the largest bucket: runs of one dy
        ("deep 64+128->64 @6x7x320", (6, 7, 320), [64, 128], 64),
    ]
    worst = 0.0
    for name, ext, cins, cout in cases:
        g = cf.make_geom(*ext)
        xs = [rand_buffer(g, c, gen, dev) for c in cins]
        affs = [rand_affine(c, gen, dev) for c in cins]
        w = torch.randn((cout, sum(cins), 3, 3, 3), generator=gen, device=dev) \
            * (27 * sum(cins)) ** -0.5
        bias = 0.1 * torch.randn(cout, generator=gen, device=dev)
        y, s = cf.fused_conv_block(xs, affs, w, bias, g)
        sync()
        yp, sp = cf.fused_conv_block_plain(xs, affs, w, bias, g)
        sync()
        err = (y.float() - yp.float()).abs().max().item()
        worst = max(worst, err)
        serr = ((s - sp).abs() / sp.abs().clamp_min(1e-6)).max().item()
        print(f"  A {name}: max|dy|={err:.3g} max rel dsums={serr:.3g}",
              flush=True)
        torch.testing.assert_close(y.float(), yp.float(), rtol=2 ** -7, atol=1e-3)
        torch.testing.assert_close(s, sp, rtol=1e-3, atol=1e-3)
        check(ring_is_zero(y), f"kernel A ring not zero ({name})")
        check(bit_equal((y, s), cf.fused_conv_block(xs, affs, w, bias, g)),
              f"kernel A: two launches differ ({name})")
    return worst


@torch.no_grad()
def phase_pool_checks(dev):
    from unetsulc_tpu_torch.ops import conv_fused as cf

    gen = torch.Generator(device=dev).manual_seed(2)
    for ext, c in (((96,) * 3, 64), ((49,) * 3, 128), ((25,) * 3, 256),
                   ((9, 8, 11), 12)):
        g = cf.make_geom(*ext)
        buf = rand_buffer(g, c, gen, dev)
        for aff in (rand_affine(c, gen, dev), None):
            y = cf.max_pool_buf(buf, aff, g)
            sync()
            yp = cf.max_pool_buf_plain(buf, aff, g)
            sync()
            check(y.dtype == yp.dtype and torch.equal(y, yp),
                  f"kernel B differs from its plain version at {ext}x{c}")
            check(ring_is_zero(y), "kernel B ring not zero")
        print(f"  B {'x'.join(map(str, ext))} x {c}: bit-equal with and "
              "without an affine",
              flush=True)


def make_inputs(dev):
    """Three graphs in the 96^3 bucket and a random-init flagship model
    saved as .mdsm with its _params.json."""
    from unetsulc_tpu_torch.data.extract import extract_data
    from unetsulc_tpu_torch.data.voxelize import bucket_size
    from unetsulc_tpu_torch.io.container import save_graph_npz
    from unetsulc_tpu_torch.io.graph import make_synthetic_graph
    from unetsulc_tpu_torch.models.unet3d import UNet3D

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    graphs = []
    for i in range(N_GRAPHS):
        g = make_synthetic_graph(np.random.default_rng(1000 + i), LABELS,
                                 n_folds_per_label=2, points_per_fold=300,
                                 extent=180)
        bck2 = extract_data(g)["bck2"]
        ext = int(np.max(bck2 - bck2.min(0))) + 1
        check(bucket_size(ext) == 96, f"graph {i} extent {ext} not in 96^3")
        path = os.path.join(WORK, f"subj{i}_L.npz")
        save_graph_npz(g, path)
        graphs.append(path)
        print(f"  graph {i}: {len(bck2)} voxels, extent {ext} -> 96^3")
    model = UNet3D(in_channels=1, out_channels=len(LABELS),
                   init_channel_number=64, device=dev, seed=0)
    model_file = os.path.join(WORK, "flagship_model.mdsm")
    torch.save(model.state_dict(), model_file)
    dict_model = {"name": "flagship", "model_file": model_file,
                  "in_channels": 1, "out_channels": len(LABELS),
                  "init_channel_number": 64, "num_filter": 64}
    params = os.path.join(WORK, "flagship_params.json")
    with open(params, "w") as f:
        json.dump({"dict_model": dict_model, "sulci_side_list": LABELS,
                   "cutting_threshold": 20}, f)
    return graphs, params, model


# each kernel's dispatcher in ops/conv_fused.py or ops/groupnorm.py
DISPATCH = {
    "conv3x3x3_fwd": "conv_fwd",
    "conv3x3x3_dx": "conv_dx",
    "conv3x3x3_wgrad": "conv_wgrad",
    "max_pool_buf_fwd": "pool_fwd",
    "max_pool_buf_bwd": "pool_bwd",
    "gn_stats": "gn_stats",
    "gn_apply": "gn_apply",
    "gn_bwd_reduce": "gn_bwd_reduce",
    "gn_bwd_dx": "gn_bwd_dx",
    "gn_stats_sums": "gn_sums",
    "gn_finalize": "gn_finalize",
}
GN_KERNELS = ["gn_stats", "gn_apply", "gn_bwd_reduce", "gn_bwd_dx"]
# the sharded GroupNorm's modes and kernel (phase 23); gn_bwd_dx_denom is
# gn_bwd_dx's dispatcher called with ``denom``
GN_SHARD_KERNELS = ["gn_stats_sums", "gn_finalize", "gn_bwd_dx_denom"]


def dispatch_module(kernel):
    from unetsulc_tpu_torch.ops import conv_fused, groupnorm

    return (groupnorm if kernel in GN_KERNELS or kernel in GN_SHARD_KERNELS
            else conv_fused)


def dispatcher(kernel):
    return getattr(dispatch_module(kernel), DISPATCH[kernel])


@contextlib.contextmanager
def patched_ops(fns):
    """Replace the dispatcher of each kernel named in ``fns`` (``kernel
    name -> function``) for the duration."""
    saved = [(dispatch_module(k), DISPATCH[k], dispatcher(k)) for k in fns]
    for k, fn in fns.items():
        setattr(dispatch_module(k), DISPATCH[k], fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def plain_fns():
    """Each kernel's plain version, by kernel name, with its dispatcher's
    signature (the packed weights are the kernels' own and unused)."""
    from unetsulc_tpu_torch.ops import conv_fused as cf
    from unetsulc_tpu_torch.ops import groupnorm as gn

    return {
        "conv3x3x3_fwd": lambda xs, affs, w, b, g, packed=None, **halo:
            cf.fused_conv_block_plain(xs, affs, w, b, g, **halo),
        "conv3x3x3_dx": lambda dconv, w, cins, br, aff, x, g, packed=None,
        halo=None, valid=None:
            cf.conv3x3x3_dx_plain(dconv, w, cins, br, aff, x, g, halo, valid),
        "conv3x3x3_wgrad": cf.conv3x3x3_wgrad_plain,
        "max_pool_buf_fwd": cf.max_pool_buf_plain,
        "max_pool_buf_bwd": cf.max_pool_buf_bwd_plain,
        "gn_stats": gn.gn_stats_plain,
        "gn_apply": gn.gn_apply_plain,
        "gn_bwd_reduce": gn.gn_bwd_reduce_plain,
        "gn_bwd_dx": gn.gn_bwd_dx_plain,
        "gn_stats_sums": gn.gn_sums_plain,
        "gn_finalize": gn.gn_finalize_plain,
    }


def plain_ops():
    """Every kernel's plain version (on the card) in place of the kernel,
    for the reference forward and train step."""
    return patched_ops(plain_fns())


def recording(calls, names):
    """Record the inputs of every call of the kernels ``names`` as
    (kernel name, args, kwargs); the calls still run their kernels."""
    def rec(name, fn):
        def call(*args, **kw):
            calls.append((name, args, kw))
            return fn(*args, **kw)
        return call

    return patched_ops({n: rec(n, dispatcher(n)) for n in names})


def volume_of(graph, dev):
    from unetsulc_tpu_torch.data.dataset import SulciDataset
    from unetsulc_tpu_torch.data.extract import extract_data
    from unetsulc_tpu_torch.io.container import read_graph

    d = extract_data(read_graph(graph))
    ds = SulciDataset([graph], {n: i for i, n in enumerate(LABELS)},
                      train=False, dict_bck2={graph: d["bck2"]},
                      dict_names={graph: d["names"]}, img_size=(96, 96, 96))
    return torch.from_numpy(ds[0][0][None]).to(dev)


@torch.no_grad()
def phase_end_to_end(dev):
    from unetsulc_tpu_torch import kernels, label
    from unetsulc_tpu_torch.method.base import SulciLabeller

    graphs, params, model = make_inputs(dev)
    out_dir = os.path.join(WORK, "labels")
    kernels.reset_launch_counts()
    t = time.time()
    label.main(["-m", params, "-g", *graphs, "-o", out_dir,
                "--threshold", "20", "--device", "cuda"])
    sync()
    wall = time.time() - t
    counts = dict(kernels.launch_counts)
    print(f"  launches on the main path: {counts}", flush=True)
    check(counts["conv3x3x3_fwd"] == 13 * N_GRAPHS,
          f"kernel A launched {counts['conv3x3x3_fwd']} times, "
          f"expected {13 * N_GRAPHS}")
    check(all(counts[k] == 0 for k in GN_KERNELS),
          "the fused labelling path launched a GroupNorm kernel")
    check(counts["max_pool_buf_fwd"] == 3 * N_GRAPHS,
          f"kernel B launched {counts['max_pool_buf_fwd']} times, "
          f"expected {3 * N_GRAPHS}")
    with open(os.path.join(out_dir, "labeling_summary.json")) as f:
        summary = json.load(f)
    check(sorted(summary) == sorted(graphs), "labeling_summary.json incomplete")
    for g in graphs:
        csv = os.path.join(out_dir, os.path.basename(g)[:-4] + "_labels.csv")
        check(os.path.exists(csv), f"missing {csv}")
        check(0.0 <= summary[g]["esi_accuracy"] <= 1.0, "bad ESI accuracy")
    print(f"label.main: {wall:.3f} s for {N_GRAPHS} graphs "
          f"(model build + load included) = {wall / N_GRAPHS * 1e3:.1f} "
          f"ms/graph", flush=True)

    # probabilities through the labeller's API: finite, rows sum to 1
    lab = SulciLabeller([], "L", dict_model={"name": "flagship"},
                        dict_bck2={}, dict_names={}, sulci_side_list=LABELS,
                        device=dev)
    lab.model = model.eval()
    from unetsulc_tpu_torch.data.extract import extract_data
    from unetsulc_tpu_torch.io.container import read_graph

    d = extract_data(read_graph(graphs[0]))
    _, ypred, yscores = lab.labeling(graphs[0], d["bck2"], d["names"])
    check(yscores.shape == (len(d["bck2"]), len(LABELS)), "yscores shape")
    check(np.isfinite(yscores).all(), "non-finite probabilities")
    check(np.allclose(yscores.sum(1), 1.0, atol=1e-4), "rows do not sum to 1")

    label_ms = label_latency(lab, graphs)

    # the same forward through the plain versions, on the card
    x = volume_of(graphs[0], dev)
    fwd = lambda: model(x, train=False, apply_final_activation=False,  # noqa: E731
                        padded_output=True)
    logits = fwd()
    with plain_ops():
        ref = fwd()
    sync()
    check_logits(logits[1:-1, 1:-1, 1:-1], ref[1:-1, 1:-1, 1:-1])
    fwd_ms = forward_ms(fwd)
    print(f"forward 96^3 flagship bf16: {fwd_ms:.2f} ms (median of 5, host "
          f"clock around a synchronized call)", flush=True)
    return model, x, counts, label_ms, fwd_ms


def label_latency(lab, graphs):
    """Label latency per graph, one graph at a time (no pipelining), split
    into read + extract; voxelize + upload + forward + argmax fetch; host
    re-segmentation + device vote. Returns the median in ms."""
    from unetsulc_tpu_torch.data.extract import extract_data
    from unetsulc_tpu_torch.io.container import read_graph

    lat, splits = [], []
    for g in graphs:
        t0 = time.perf_counter()
        d = extract_data(read_graph(g))
        t1 = time.perf_counter()
        h = lab._labeling_dispatch(g, d["bck2"], d["names"])
        lab._fetch_ypred(h)
        t2 = time.perf_counter()
        lab._cut_labels_device(h, d["vert"], d["bck2"], [20])
        t3 = time.perf_counter()
        lat.append((t3 - t0) * 1e3)
        splits.append([(t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3])
    label_ms = statistics.median(lat)
    print(f"label latency: {label_ms:.1f} ms/graph (median of {len(lat)}: "
          + ", ".join(f"{v:.1f}" for v in lat) + ")", flush=True)
    med = [statistics.median(s[i] for s in splits) for i in range(3)]
    print(f"  split (medians): read+extract {med[0]:.1f} ms, voxelize+"
          f"forward {med[1]:.1f} ms, cut+vote {med[2]:.1f} ms", flush=True)
    return label_ms


def check_logits(li, ri):
    """The kernels' logits li against the plain versions' ri: within
    ``LOGIT_TOL`` x max |logit|, and the same argmax wherever the top-2
    margin is clear of twice that."""
    check(bool(torch.isfinite(li).all()), "non-finite logits")
    err = (li - ri).abs().max().item()
    tol = LOGIT_TOL * ri.abs().max().item()
    top2 = ri.topk(2, -1).values
    sure = (top2[..., 0] - top2[..., 1]) > 2 * tol
    agree = (li.argmax(-1) == ri.argmax(-1))
    print(f"  forward vs plain: max|dlogit|={err:.4g} (tol {tol:.4g} = "
          f"{LOGIT_TOL} x max|logit|); argmax agrees on "
          f"{agree.float().mean().item() * 100:.3f}% of voxels, "
          f"{agree[sure].float().mean().item() * 100 if sure.any() else 100:.3f}% "
          f"of the {int(sure.sum())} with a top-2 margin > 2 tol", flush=True)
    check(err <= tol, "kernel forward differs from the plain forward")
    check(bool(agree[sure].all()), "argmax differs where the margin is clear")


def forward_ms(fwd):
    """Median of 5 host-clock times of a synchronized ``fwd()``, after 2
    warm-up calls."""
    for _ in range(2):
        fwd()
    sync()
    times = []
    for _ in range(5):
        t = time.time()
        fwd()
        sync()
        times.append((time.time() - t) * 1e3)
    return statistics.median(times)


@torch.no_grad()
def phase_timing(model, x):
    from unetsulc_tpu_torch.ops import conv_fused as cf

    calls = []
    with recording(calls, ["conv3x3x3_fwd", "max_pool_buf_fwd"]):
        model(x, train=False, apply_final_activation=False, padded_output=True)
    sync()
    rows = {"conv3x3x3_fwd": [], "max_pool_buf_fwd": []}
    for name, args, kw in calls:
        if name == "conv3x3x3_fwd":
            xs, affs, w, b, g = args[:5]
            kern = lambda: cf.conv_fwd(*args, **kw)  # noqa: E731
            plain = lambda: cf.fused_conv_block_plain(xs, affs, w, b, g)  # noqa: E731
            lib = conv_library_call(xs, affs, w, b, g)
            bound, _, _ = conv_bound(xs, int(w.shape[0]))
            shape = f"{'+'.join(str(int(v.shape[3])) for v in xs)}->{int(w.shape[0])} @{g.X}x{g.Y}x{g.Z}"
        else:
            buf, aff, g = args
            kern = lambda: cf.pool_fwd(buf, aff, g)  # noqa: E731
            plain = lambda: cf.max_pool_buf_plain(buf, aff, g)  # noqa: E731
            lib = pool_library_call(buf, aff, g)
            bound = pool_bound(buf)
            shape = f"{int(buf.shape[3])} @{g.X}x{g.Y}x{g.Z}"
        # held to the tolerances of phases 3 and 4
        out_k, out_p = kern(), plain()
        sync()
        if name == "conv3x3x3_fwd":
            (yk, sk), (yp, sp) = out_k, out_p
            torch.testing.assert_close(yk.float(), yp.float(), rtol=2 ** -7,
                                       atol=1e-3)
            torch.testing.assert_close(sk, sp, rtol=1e-3, atol=1e-3)
        else:
            yk, yp = out_k, out_p
            check(yk.dtype == yp.dtype and torch.equal(yk, yp),
                  f"kernel B differs from its plain version at {shape}")
        check(ring_is_zero(yk), f"{name} ring not zero at {shape}")
        err = (yk.float() - yp.float()).abs().max().item()
        del out_k, out_p, yk, yp
        rows[name].append(timed_row(name, shape, kern, plain, lib, bound, err))
    level_shares("conv3x3x3_fwd", rows["conv3x3x3_fwd"])
    return rows


@torch.no_grad()
def phase_profile(model, x, padded=True):
    """Where one flagship forward's time goes: device time by kernel name
    (torch.profiler), the device's busy share of the forward's host-clock
    time, and the forward's peak device memory."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fwd = lambda: model(x, train=False, apply_final_activation=False,  # noqa: E731
                        padded_output=padded)
    fwd()
    sync()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fwd()
        sync()
        wall_ms = (time.perf_counter() - t) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # device-side events only: a host op's entry repeats its kernels' time
    kernels = [(e.key, e.count, e.self_device_time_total / 1e3)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, _, ms in kernels)
    print(f"  forward under the profiler: {wall_ms:.2f} ms host clock, peak "
          f"device memory {peak_gb:.2f} GB", flush=True)
    if not kernels:
        print("  device busy share: not measured (the profiler saw no device "
              "time)", flush=True)
        return
    print(f"  device busy {busy_ms:.2f} ms = {busy_ms / wall_ms * 100:.1f}% "
          f"of the forward", flush=True)
    for key, count, ms in sorted(kernels, key=lambda k: -k[2])[:12]:
        print(f"    {ms:9.3f} ms {count:4d}x  {key[:90]}", flush=True)


@torch.no_grad()
def phase_backward_checks(dev):
    """Kernels C, D, E against their plain versions at the flagship levels
    and one shape with channel tails; returns each kernel's max |error|."""
    from unetsulc_tpu_torch.ops import conv_fused as cf

    gen = torch.Generator(device=dev).manual_seed(3)
    worst = {"conv3x3x3_dx": 0.0, "conv3x3x3_wgrad": 0.0,
             "max_pool_buf_bwd": 0.0}
    cases = [
        ("enc0.conv2 32->64 @96^3", (96, 96, 96), [32], 64),
        ("dec2.conv1 64+128->64 @96^3", (96, 96, 96), [64, 128], 64),
        ("enc1.conv2 64->128 @49^3", (49, 49, 49), [64], 128),
        ("dec0.conv1 256+512->256 @25^3", (25, 25, 25), [256, 512], 256),
        ("enc3.conv2 256->512 @13^3", (13, 13, 13), [256], 512),
        ("tails 12+20->10 @7x9x5", (7, 9, 5), [12, 20], 10),
        # the edges of kernels C and D's tiles: 13 planes of 49 x 49, two
        # branches whose channels are not multiples of 64, Cout 48
        ("edges 96+160->48 @13x49x49", (13, 49, 49), [96, 160], 48),
        # deep Z: D's 128-position steps (Z beyond 189), and C's runs of
        # one dy (Z beyond 225 at an N tile of 128)
        ("deep 64->64 @3x5x200", (3, 5, 200), [64], 64),
        ("deeper 128->128 @3x4x240", (3, 4, 240), [128], 128),
        # a volume rounded up past the largest bucket (289-320 -> 320):
        # D's one run per dy, C's one-dy runs
        ("deep 64+128->64 @6x7x320", (6, 7, 320), [64, 128], 64),
    ]
    for name, ext, cins, cout in cases:
        g = cf.make_geom(*ext)
        xs = [rand_buffer(g, c, gen, dev) for c in cins]
        affs = [rand_affine(c, gen, dev) for c in cins]
        w = torch.randn((cout, sum(cins), 3, 3, 3), generator=gen, device=dev) \
            * (27 * sum(cins)) ** -0.5
        dconv = rand_grad(g, cout, gen, dev)
        for b in range(len(cins)):
            what = f"{name} branch {b}"
            out_k = cf.conv_dx(dconv, w, cins, b, affs[b], xs[b], g)
            wk = cf.conv_wgrad(xs[b], affs[b], dconv, g)
            sync()
            out_p = cf.conv3x3x3_dx_plain(dconv, w, cins, b, affs[b], xs[b], g)
            wp = cf.conv3x3x3_wgrad_plain(xs[b], affs[b], dconv, g)
            sync()
            e_c = check_dx(out_k, out_p, what)
            e_d = check_grad(wk, wp, 1e-3, f"kernel D ({what})")
            check(bit_equal(out_k, cf.conv_dx(dconv, w, cins, b, affs[b],
                                              xs[b], g)),
                  f"kernel C: two launches differ ({what})")
            check(bit_equal(wk, cf.conv_wgrad(xs[b], affs[b], dconv, g)),
                  f"kernel D: two launches differ ({what})")
            worst["conv3x3x3_dx"] = max(worst["conv3x3x3_dx"], e_c)
            worst["conv3x3x3_wgrad"] = max(worst["conv3x3x3_wgrad"], e_d)
            print(f"  C {what}: max|ddx|={e_c:.3g} (max|dx| "
                  f"{out_p[0].float().abs().max().item():.3g}); D: max|ddW|="
                  f"{e_d:.3g} (max|dW| {wp.abs().max().item():.3g})",
                  flush=True)
    for ext, c in (((96,) * 3, 64), ((49,) * 3, 128), ((25,) * 3, 256),
                   ((9, 8, 11), 12)):
        g = cf.make_geom(*ext)
        buf = rand_buffer(g, c, gen, dev)
        # ties: the buffer quantized to 0, 0.5 and 1, so that windows hold
        # equal maxima (the ring stays 0)
        tied = (torch.round(buf.float() * 2) / 2).clamp(max=1.0).to(buf.dtype)
        for b, kind in ((buf, "random"), (tied, "tied")):
            for aff in (rand_affine(c, gen, dev), None):
                what = (f"{ext}x{c}, {kind}, "
                        f"{'no affine' if aff is None else 'affine'}")
                out = cf.pool_fwd(b, aff, g)
                cot = rand_grad(cf.pool_geom(g), c, gen, dev)
                out_k = cf.pool_bwd(b, aff, out, cot, g)
                again = cf.pool_bwd(b, aff, out, cot, g)
                sync()
                out_p = cf.max_pool_buf_bwd_plain(b, aff, out, cot, g)
                sync()
                check_pool_bwd(out_k, out_p, what)
                check(bit_equal(tuple(t for t in out_k if t is not None),
                                tuple(t for t in again if t is not None)),
                      f"kernel E: two launches differ ({what})")
                if aff is not None and kind == "random" and ext[0] in (96, 9):
                    # every dx and dab element written by the kernel: a
                    # launch into NaN-filled outputs and workspace
                    dx, dab = pool_bwd_into_nan(b, aff, out, cot)
                    check_pool_bwd((dx, dab), out_p, f"{what}, into NaN")
        print(f"  E {'x'.join(map(str, ext))} x {c}: dx bit-equal with and "
              "without an affine, on random and tied inputs, d(affine) within "
              "rtol 1e-3, two launches bit-equal"
              + (", and into NaN-filled outputs through the C entry point"
                 if ext[0] in (96, 9) else ""), flush=True)
    return worst


def pool_bwd_into_nan(buf, aff, out, cot):
    """Kernel E through its C entry point, into a dx, a dab and a workspace
    filled with NaN: any element the kernel fails to write stays NaN. Not
    a launch of the main path, so not counted."""
    from unetsulc_tpu_torch import kernels
    from unetsulc_tpu_torch.kernels import layout

    c = int(buf.shape[3])
    x, y, z = (int(v) - 2 for v in buf.shape[:3])
    sms = torch.cuda.get_device_properties(buf.device).multi_processor_count
    ab = aff.float().contiguous()
    nan = float("nan")
    dx = torch.full_like(buf, nan)
    dab = torch.full((2, c), nan, dtype=torch.float32, device=buf.device)
    ws = torch.full((layout.pool_bwd_workspace(c, x, y, z, sms),), nan,
                    dtype=torch.float32, device=buf.device)
    err = kernels._kernel("max_pool_buf_bwd")(
        buf.data_ptr(), ab.data_ptr(), out.data_ptr(),
        cot.to(out.dtype).contiguous().data_ptr(), c, x, y, z, sms,
        dx.data_ptr(), dab.data_ptr(), ws.data_ptr(),
        torch.cuda.current_stream(buf.device).cuda_stream)
    check(err == 0, f"kernel E's C entry point returned CUDA error {err}")
    sync()
    return dx, dab


def make_batch(dev, seed=0):
    """bench.py:38-45's batch: numpy seed 0, 2% of the voxels occupied,
    labels 0..62 there and -1 elsewhere (another volume from another
    ``seed``)."""
    rng = np.random.default_rng(seed)
    inputs = (rng.random((1, *VOLUME, 1)) < 0.02).astype(np.float32)
    labels = np.where(inputs[..., 0] > 0,
                      rng.integers(0, CLASSES, (1, *VOLUME)), -1)
    return (torch.from_numpy(inputs).to(dev),
            torch.from_numpy(labels.astype(np.int64)).to(dev))


def param_distances(ga, gb):
    """Per parameter of gradients ``ga`` and ``gb``: (1 - cosine,
    max |ga - gb| / max |gb|)."""
    out = {}
    for n, b in gb.items():
        u, v = ga[n].double().flatten(), b.double().flatten()
        cos = (u @ v / (u.norm() * v.norm()).clamp_min(1e-300)).item()
        err = (u - v).abs().max().item() / max(v.abs().max().item(), 1e-300)
        out[n] = (1.0 - cos, err)
    return out


def global_cosine(ga, gb):
    """Cosine of all parameters' gradients together."""
    u = torch.cat([ga[n].double().flatten() for n in gb])
    v = torch.cat([gb[n].double().flatten() for n in gb])
    return (u @ v / (u.norm() * v.norm()).clamp_min(1e-300)).item()


def worst(dists):
    """(worst 1 - cosine, its parameter, worst error, its parameter)."""
    c = max(dists, key=lambda n: dists[n][0])
    e = max(dists, key=lambda n: dists[n][1])
    return dists[c][0], c, dists[e][1], e


def kernel_class(key):
    """Which of the port's kernels a profiler entry is ("fold": the
    fixed-order fold that A, C and D launch beside their kernels;
    "memset": memsets and PyTorch's zero and constant fills), or
    "plain"."""
    if "fold_cols_kernel" in key:
        return "fold"
    if key.startswith("Memset") or "FillFunctor" in key:
        return "memset"
    if "conv3x3x3_wgrad_kernel" in key:
        return "D"
    if "conv3x3x3_dx_kernel" in key:
        return "C"
    if "conv3x3x3_fwd_kernel" in key:
        return "A"
    if "max_pool_buf_bwd_kernel" in key:
        return "E"
    if "max_pool_buf_fwd_kernel" in key:
        return "B"
    if "gn_stats_kernel" in key and ", true>" in key:
        return "gn_stats_sums"
    for name in GN_KERNELS + ["gn_finalize"]:
        if f"{name}_kernel" in key:
            return name
    return "plain"


def profile_step(run, label, top):
    """Where one step's time goes: ``run()`` under the profiler, device time
    by kernel class (the port's kernels by letter or name, the fold and
    the memsets and fills, everything else "plain"), the device's busy
    share of the host-clock time, and the ``top`` largest plain entries."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        sync()
        prof_ms = (time.perf_counter() - t) * 1e3
    by_class, plain = {}, []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            k = kernel_class(e.key)
            ms = e.self_device_time_total / 1e3
            by_class[k] = by_class.get(k, 0.0) + ms
            if k == "plain":
                plain.append((ms, e.count, e.key))
    busy = sum(by_class.values())
    if not busy:
        print("  device busy share: not measured (the profiler saw no device "
              "time)", flush=True)
        return
    print(f"  {label} under the profiler: {prof_ms:.2f} ms host clock, device "
          f"busy {busy:.2f} ms = {busy / prof_ms * 100:.1f}%; "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(by_class.items())),
          flush=True)
    for ms, count, key in sorted(plain, reverse=True)[:top]:
        print(f"    {ms:9.3f} ms {count:4d}x  {key[:90]}", flush=True)


def step_against_plain(model, step, x, labels, where, f32_model=None):
    """One step from the model's current state through the kernels
    (twice: their spread is printed) and through the plain versions on the
    card, each at lr 0 so the state stays as it is; held to ``LOSS_RTOL``,
    ``GLOBAL_COS``, ``GRAD_COS`` and ``GRAD_ERR``. With ``f32_model`` (the
    same parameters, f32 compute), also prints both bf16 steps' distance
    from its plain step."""
    from unetsulc_tpu_torch.train.step import TrainState, make_train_step

    def run(m, step_fn, plain):
        probe = TrainState.create(m, lr=0.0)
        with plain_ops() if plain else contextlib.nullcontext():
            loss, counts = step_fn(probe, x, labels)
        sync()
        return loss.item(), counts, {
            n: p.grad.detach().clone() for n, p in m.named_parameters()}

    (lk, ck, gk), (lk2, _, gk2) = run(model, step, False), run(model, step, False)
    check(lk == lk2 and all(torch.equal(gk[n], gk2[n]) for n in gk),
          f"two kernel steps from one state differ ({where}): the kernels "
          "are deterministic")
    lp, cp, gp = run(model, step, True)
    print(f"  {where}: loss {lk:.6f} vs plain {lp:.6f} (rel "
          f"{abs(lk - lp) / abs(lp):.2e}); confusion counts equal: "
          f"{bool(torch.equal(ck, cp))}", flush=True)
    kp = param_distances(gk, gp)
    rows = [("kernel step vs kernel step", param_distances(gk, gk2),
             global_cosine(gk, gk2)),
            ("kernel step vs plain step", kp, global_cosine(gk, gp))]
    if f32_model is not None:
        with torch.no_grad():
            f32_model.load_state_dict(model.state_dict())
        l32, _, g32 = run(f32_model,
                          make_train_step(f32_model, CLASSES, momentum=0.9),
                          True)
        print(f"    f32 plain step loss {l32:.6f}", flush=True)
        rows += [("kernel step vs f32 step", param_distances(gk, g32),
                  global_cosine(gk, g32)),
                 ("plain step vs f32 step", param_distances(gp, g32),
                  global_cosine(gp, g32))]
    for label, d, gcos in rows:
        c, cn, e, en = worst(d)
        print(f"    {label}: all-parameter cosine {gcos:.6f}; worst cosine "
              f"{1.0 - c:.6f} ({cn}); worst max|dg| / max|g| {e:.4f} ({en})",
              flush=True)
    c, _, e, _ = worst(kp)
    gcos = rows[1][2]
    check(abs(lk - lp) <= LOSS_RTOL * abs(lp),
          f"loss differs from the plain step ({where})")
    check(gcos >= GLOBAL_COS,
          f"all-parameter gradient cosine {gcos} < {GLOBAL_COS} ({where})")
    check(1.0 - c >= GRAD_COS, f"gradient cosine {1.0 - c} < {GRAD_COS} ({where})")
    check(e <= GRAD_ERR, f"gradient error {e} > {GRAD_ERR} ({where})")
    return dict(loss=lk, plain_loss=lp, global_cos=gcos, cos=1.0 - c, err=e)


def phase_train(dev):
    """The flagship training step end to end (see the module docstring)."""
    from unetsulc_tpu_torch import kernels
    from unetsulc_tpu_torch.models.unet3d import UNet3D
    from unetsulc_tpu_torch.train.step import TrainState, make_train_step

    model = UNet3D(in_channels=1, out_channels=CLASSES,
                   init_channel_number=64, device=dev, seed=0)
    x, labels = make_batch(dev)
    step = make_train_step(model, CLASSES, momentum=0.9)

    # the step against the plain step from the initial state, and both
    # against an f32 step (a model of the same parameters with f32
    # compute, moved to the card: the plain versions take f32)
    f32_model = UNet3D(in_channels=1, out_channels=CLASSES,
                       init_channel_number=64, device="cpu", seed=0,
                       compute_dtype=torch.float32).to(dev)
    at_init = step_against_plain(model, step, x, labels, "initial state",
                                 f32_model)
    del f32_model

    # 3 warm-up and 20 timed steps, losses on the device and one fetch at
    # the end (bench.py:92-106); launch counts zeroed just before the
    # first, which runs with host syncs turned into errors: the step never
    # waits for the device
    state = TrainState.create(model, lr=TRAIN_LR)
    kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = [step(state, x, labels)[0]]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sync()
    print("  a step under torch.cuda.set_sync_debug_mode('error'): no host "
          "sync", flush=True)
    launches = dict(kernels.launch_counts)
    print(f"  launches per train step: {launches}", flush=True)
    want = {k: 0 for k in launches}
    want.update(conv3x3x3_fwd=13, max_pool_buf_fwd=3, conv3x3x3_dx=16,
                conv3x3x3_wgrad=16, max_pool_buf_bwd=3)
    check(launches == want, f"launches per step {launches}, expected {want}")
    for _ in range(WARMUP - 1):
        losses.append(step(state, x, labels)[0])
    losses[-1].item()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    for _ in range(STEPS):
        losses.append(step(state, x, labels)[0])
    curve = torch.stack(losses).cpu()
    dt = time.perf_counter() - t
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = dt / STEPS * 1e3
    vox_s = np.prod(VOLUME) * STEPS / dt
    print(f"train step 96^3 flagship bf16: {step_ms:.2f} ms/step, "
          f"{vox_s:.1f} voxels/s, peak device memory {peak_gb:.2f} GB "
          f"({STEPS} steps after {WARMUP} warm-up)", flush=True)
    print("  loss by step: " + ", ".join(f"{v:.4f}" for v in curve.tolist()),
          flush=True)
    check(bool(torch.isfinite(curve).all()), "non-finite loss")
    check(curve[-1].item() < curve[0].item(),
          f"loss did not fall: step {len(curve)} {curve[-1].item():.4f} >= "
          f"step 1 {curve[0].item():.4f}")

    # the step against the plain step again from a trained state, where
    # the bf16 gradients are far less noisy than at the initial state
    while state.step < TRAINED_STEPS:
        step(state, x, labels)
    trained = step_against_plain(model, step, x, labels,
                                 f"state after {TRAINED_STEPS} steps")

    profile_step(lambda: step(state, x, labels), "one step", 10)

    # a head-only step: no backward kernel, the trunk bit-identical
    fstate = TrainState.create(model, lr=TRAIN_LR,
                               training_layers=["final_conv"])
    trunk = {n: p.detach().clone() for n, p in model.named_parameters()
             if not n.startswith("final_conv")}
    kernels.reset_launch_counts()
    step(fstate, x, labels)
    sync()
    frozen = dict(kernels.launch_counts)
    print(f"  launches of a final_conv-only step: {frozen}", flush=True)
    check(all(frozen[k] == 0 for k in
              ("conv3x3x3_dx", "conv3x3x3_wgrad", "max_pool_buf_bwd")),
          "a final_conv-only step launched a backward kernel")
    check(all(torch.equal(p, trunk[n]) for n, p in model.named_parameters()
              if n in trunk), "a frozen trunk parameter changed")
    stats = dict(step_ms=step_ms, voxels_per_s=vox_s, peak_gb=peak_gb,
                 loss_first=curve[0].item(), loss_last=curve[-1].item(),
                 at_init=at_init, trained=trained)
    return launches, stats, model, step, x, labels


def phase_backward_timing(model, step, x, labels):
    """Every C, D, E launch of one training step, recorded, held to its
    plain version and timed. The recorded step runs at lr 0, so the weights
    that the launches read are still those of the recorded inputs."""
    from unetsulc_tpu_torch.train.step import TrainState

    names = ["conv3x3x3_dx", "conv3x3x3_wgrad", "max_pool_buf_bwd"]
    calls = []
    with recording(calls, names):
        step(TrainState.create(model, lr=0.0), x, labels)
    sync()
    plain_of = plain_fns()
    rows = {n: [] for n in names}
    with torch.no_grad():
        for name, args, kw in calls:
            kern = lambda: dispatcher(name)(*args, **kw)  # noqa: E731
            plain = lambda: plain_of[name](*args)  # noqa: E731
            if name == "conv3x3x3_dx":
                dconv, w, cins, br, aff, xb, g = args[:7]
                c0 = sum(cins[:br])
                lib = conv_bwd_library_call(xb, aff, dconv,
                                            w[:, c0:c0 + cins[br]], g,
                                            [True, False, False])
                bound = dx_bound(dconv, xb)
                shape = f"{cins[br]}<-{int(w.shape[0])} @{g.X}x{g.Y}x{g.Z}"
                out = kern()
                err = check_dx(out, plain(), shape)
                check(bit_equal(out, kern()),
                      f"kernel C: two launches differ ({shape})")
            elif name == "conv3x3x3_wgrad":
                xb, aff, dconv, g = args[:4]
                ci, co = int(xb.shape[3]), int(dconv.shape[3])
                lib = conv_bwd_library_call(
                    xb, aff, dconv,
                    torch.zeros((co, ci, 3, 3, 3), device=xb.device), g,
                    [False, True, False])
                bound = wgrad_bound(xb, dconv)
                shape = f"{ci}x{co} @{g.X}x{g.Y}x{g.Z}"
                out = kern()
                err = check_grad(out, plain(), 1e-3, f"kernel D {shape}")
                check(bit_equal(out, kern()),
                      f"kernel D: two launches differ ({shape})")
                # the yardstick as earlier versions of this phase built it
                old_lib = graph_ms(conv_bwd_library_call(
                    xb, aff, dconv,
                    torch.zeros((co, ci, 3, 3, 3), device=xb.device), g,
                    [False, True, False], batch_stride_c=True))
            else:
                buf, aff, out, cot, g = args
                lib = pool_bwd_library_call(buf, aff, cot, g)
                bound = pool_bwd_bound(buf)
                shape = f"{int(buf.shape[3])} @{g.X}x{g.Y}x{g.Z}"
                err = check_pool_bwd(kern(), plain(), shape)
                # the card's streaming rate on E's bytes: a plain copy of x
                dst = torch.empty_like(buf)
                copy_ms = graph_ms(lambda: dst.copy_(buf))
            sync()
            rows[name].append(timed_row(name, shape, kern, plain, lib, bound,
                                        err))
            if name == "max_pool_buf_bwd":
                rows[name][-1]["copy_ms"] = copy_ms
                moved = 2.0 * buf.numel() * buf.element_size()
                print(f"    a copy_ of x ({moved / 1e6:.0f} MB moved): "
                      f"{copy_ms:.4f} ms, {moved / copy_ms / 1e9:.2f} TB/s",
                      flush=True)
            if name == "conv3x3x3_wgrad":
                rows[name][-1]["library_batch_stride_c_ms"] = old_lib
                print(f"    library on the batch-stride-C view (the earlier "
                      f"yardstick): {old_lib:.4f} ms", flush=True)
    for name in names:
        level_shares(name, rows[name])
    return rows


# ---------------------------------------------------------------------------
# the non-fused path: GroupNorm kernels, labelling, training (phases 12-15)
# ---------------------------------------------------------------------------

# the GroupNorms of the flagship non-fused forward: (layer, extent, C), G 32
GN_LAYERS = [
    ("enc0.norm1", 96, 32), ("enc0.norm2", 96, 64),
    ("enc1.norm1", 49, 64), ("enc1.norm2", 49, 128),
    ("enc2.norm1", 25, 128), ("enc2.norm2", 25, 256),
    ("enc3.norm1", 13, 256), ("enc3.norm2", 13, 512),
    ("dec0.norm1", 25, 256), ("dec0.norm2", 25, 256),
    ("dec1.norm1", 49, 128), ("dec1.norm2", 49, 128),
    ("dec2.norm1", 96, 64), ("dec2.norm2", 96, 64),
]


def gn_inputs(n, s, c, dtype, gen, dev):
    """A post-ReLU-like (N, S, C) slab (exact zeros, ties), a small
    cotangent of both signs, scale ~ 1 and bias ~ 0 (f32)."""
    x = torch.relu(torch.randn((n, s, c), generator=gen, device=dev)).to(dtype)
    g = (1e-3 * torch.randn((n, s, c), generator=gen, device=dev)).to(dtype)
    scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)
    bias = 0.1 * torch.randn(c, generator=gen, device=dev)
    return x, g, scale, bias


def check_gn(x, g, scale, bias, groups, what):
    """Each GroupNorm kernel against its plain version on the same inputs
    (apply, reduce and dx fed the plain statistics): mean and inv rtol
    1e-4; apply within 1 bf16 ulp (2^-7 |p| + 1e-3); reduce rtol 1e-3 with
    atol 1e-3 max|p|; dx as kernel C (2^-7 |p| + 1e-3 max|p|). Returns
    each kernel's max |error|."""
    from unetsulc_tpu_torch.ops import groupnorm as gn

    mean, inv = gn.gn_stats(x, groups, 1e-5)
    pm, pi = gn.gn_stats_plain(x, groups, 1e-5)
    sync()
    torch.testing.assert_close(mean, pm, rtol=1e-4, atol=0,
                               msg=lambda m: f"gn_stats mean ({what}): {m}")
    torch.testing.assert_close(inv, pi, rtol=1e-4, atol=0,
                               msg=lambda m: f"gn_stats inv ({what}): {m}")
    err = {"gn_stats": max((mean - pm).abs().max().item(),
                           (inv - pi).abs().max().item())}
    yk = gn.gn_apply(x, pm, pi, scale, bias)
    yp = gn.gn_apply_plain(x, pm, pi, scale, bias)
    sync()
    check(yk.dtype == x.dtype, f"gn_apply dtype ({what})")
    torch.testing.assert_close(yk.float(), yp.float(), rtol=2 ** -7, atol=1e-3,
                               msg=lambda m: f"gn_apply ({what}): {m}")
    err["gn_apply"] = (yk.float() - yp.float()).abs().max().item()
    rk = gn.gn_bwd_reduce(x, g, pm, pi, scale)
    rp = gn.gn_bwd_reduce_plain(x, g, pm, pi, scale)
    sync()
    err["gn_bwd_reduce"] = max(
        check_grad(k, p, 1e-3, f"gn_bwd_reduce {i} ({what})")
        for i, (k, p) in enumerate(zip(rk, rp)))
    dk = gn.gn_bwd_dx(x, g, pm, pi, scale, rp[2], rp[3])
    dp = gn.gn_bwd_dx_plain(x, g, pm, pi, scale, rp[2], rp[3])
    sync()
    check(dk.dtype == x.dtype, f"gn_bwd_dx dtype ({what})")
    err["gn_bwd_dx"] = check_grad(dk, dp, 2 ** -7, f"gn_bwd_dx ({what})")
    return err


@torch.no_grad()
def phase_gn_checks(dev):
    """The four GroupNorm kernels against their plain versions at the 14
    GroupNorms of the flagship non-fused forward (bf16, G 32), one in f32,
    and one with N 2, odd extents and a channel count off the 16-byte
    vectors; each of the four is the same in two runs."""
    from unetsulc_tpu_torch.ops import groupnorm as gn

    gen = torch.Generator(device=dev).manual_seed(12)
    cases = [(f"{name} {ext}^3 x {c} bf16", 1, ext ** 3, c, torch.bfloat16, 32)
             for name, ext, c in GN_LAYERS]
    cases += [("enc1.norm2 49^3 x 128 f32", 1, 49 ** 3, 128, torch.float32, 32),
              ("N 2, 9x7x5 x 36 bf16, G 12", 2, 9 * 7 * 5, 36, torch.bfloat16,
               12)]
    worst = {k: 0.0 for k in GN_KERNELS}
    for what, n, s_, c, dtype, groups in cases:
        x, g, scale, bias = gn_inputs(n, s_, c, dtype, gen, dev)
        err = check_gn(x, g, scale, bias, groups, what)
        for k, v in err.items():
            worst[k] = max(worst[k], v)
        print(f"  GN {what}: " + ", ".join(f"{k} {v:.3g}" for k, v in err.items()),
              flush=True)
    x, g, scale, bias = gn_inputs(1, 96 ** 3, 64, torch.bfloat16, gen, dev)
    stats = gn.gn_stats(x, 32, 1e-5)
    check(bit_equal(stats, gn.gn_stats(x, 32, 1e-5)),
          "gn_stats differs between two runs")
    y = gn.gn_apply(x, *stats, scale, bias)
    check(bit_equal(y, gn.gn_apply(x, *stats, scale, bias)),
          "gn_apply differs between two runs")
    red = gn.gn_bwd_reduce(x, g, *stats, scale)
    check(bit_equal(red, gn.gn_bwd_reduce(x, g, *stats, scale)),
          "gn_bwd_reduce differs between two runs")
    dx = gn.gn_bwd_dx(x, g, *stats, scale, red[2], red[3])
    check(bit_equal(dx, gn.gn_bwd_dx(x, g, *stats, scale, red[2], red[3])),
          "gn_bwd_dx differs between two runs")
    print("  gn_stats, gn_apply, gn_bwd_reduce, gn_bwd_dx: each "
          "bit-identical in two runs at 96^3 x 64", flush=True)
    return worst


def nonfused_model(dev, **kw):
    """The flagship model with the transposed-conv decoder (in 1, init 64,
    63 classes, 'crg', num_conv 1, interpolate=False, bf16), seed 0."""
    from unetsulc_tpu_torch.models.unet3d import UNet3D

    return UNet3D(in_channels=1, out_channels=CLASSES, init_channel_number=64,
                  interpolate=False, device=dev, seed=0, **kw)


@contextlib.contextmanager
def gn_layouts(seen):
    """Record, for every GroupNorm call of the non-fused model, whether its
    input arrived contiguous in (N, X, Y, Z, C), i.e. cuDNN's conv output
    was channels-last and the kernels read it in place."""
    from unetsulc_tpu_torch.models import unet3d

    orig = unet3d.group_norm

    def call(x, *args, **kw):
        seen.append(x.is_contiguous())
        return orig(x, *args, **kw)

    unet3d.group_norm = call
    try:
        yield
    finally:
        unet3d.group_norm = orig


@torch.no_grad()
def phase_nonfused_labelling(dev):
    """Labelling on the non-fused path end to end: a random flagship
    interpolate=False model saved as .mdsm (with its ``upsample`` keys),
    ``label.main`` on phase 5's three graphs with the launch counts zeroed
    just before and read just after; label latency and forward time; the
    same forward with the plain GroupNorm on the card."""
    from unetsulc_tpu_torch import kernels, label
    from unetsulc_tpu_torch.method.base import SulciLabeller

    model = nonfused_model(dev)
    state = model.state_dict()
    check(sum("upsample" in k for k in state) == 6, "no upsample keys")
    model_file = os.path.join(WORK, "transposed_model.mdsm")
    torch.save(state, model_file)
    width = model.init_channel_number
    dict_model = {"name": "transposed", "model_file": model_file,
                  "in_channels": 1, "out_channels": CLASSES,
                  "init_channel_number": width, "num_filter": width,
                  "interpolate": False}
    params = os.path.join(WORK, "transposed_params.json")
    with open(params, "w") as f:
        json.dump({"dict_model": dict_model, "sulci_side_list": LABELS,
                   "cutting_threshold": 20}, f)
    graphs = [os.path.join(WORK, f"subj{i}_L.npz") for i in range(N_GRAPHS)]
    out_dir = os.path.join(WORK, "labels_transposed")
    kernels.reset_launch_counts()
    t = time.time()
    label.main(["-m", params, "-g", *graphs, "-o", out_dir,
                "--threshold", "20", "--device", str(dev)])
    sync()
    wall = time.time() - t
    counts = dict(kernels.launch_counts)
    print(f"  launches on the non-fused labelling path: {counts}", flush=True)
    want = {k: 0 for k in counts}
    want.update(gn_stats=14 * N_GRAPHS, gn_apply=14 * N_GRAPHS)
    check(counts == want, f"launches {counts}, expected {want}")
    with open(os.path.join(out_dir, "labeling_summary.json")) as f:
        summary = json.load(f)
    check(sorted(summary) == sorted(graphs), "labeling_summary.json incomplete")
    print(f"label.main (non-fused): {wall:.3f} s for {N_GRAPHS} graphs "
          f"(model build + load included)", flush=True)

    lab = SulciLabeller([], "L", dict_model={"name": "transposed"},
                        dict_bck2={}, dict_names={}, sulci_side_list=LABELS,
                        device=dev)
    lab.model = model.eval()
    label_ms = label_latency(lab, graphs)

    x = volume_of(graphs[0], dev)
    fwd = lambda: model(x, train=False, apply_final_activation=False)  # noqa: E731
    seen = []
    with gn_layouts(seen):
        logits = fwd()
    print(f"  GroupNorm inputs contiguous channels-last (read in place): "
          f"{sum(seen)} of {len(seen)}; copied first: "
          f"{[GN_LAYERS[i][0] for i, ok in enumerate(seen) if not ok]}",
          flush=True)
    with patched_ops({k: plain_fns()[k] for k in ("gn_stats", "gn_apply")}):
        ref = fwd()
    sync()
    check(tuple(logits.shape) == (1, *VOLUME, CLASSES), "logits shape")
    check_logits(logits[0], ref[0])
    fwd_ms = forward_ms(fwd)
    print(f"forward 96^3 flagship bf16, non-fused: {fwd_ms:.2f} ms (median of "
          f"5, host clock around a synchronized call)", flush=True)
    phase_profile(model, x, padded=False)
    return counts, label_ms, fwd_ms


def phase_nonfused_train(dev):
    """The training step of the non-fused flagship model on phase 9's
    batch: against the plain step (only GroupNorm differs) at phase 9's
    bars; launches per step; 3 warm-up and 20 timed steps; a falling loss;
    peak memory; a profile of one step; one step with dropout 0.1 at batch
    2."""
    from unetsulc_tpu_torch import kernels
    from unetsulc_tpu_torch.train.step import TrainState, make_train_step

    model = nonfused_model(dev)
    x, labels = make_batch(dev)
    step = make_train_step(model, CLASSES, momentum=0.9)
    at_init = step_against_plain(model, step, x, labels,
                                 "initial state, non-fused")

    state = TrainState.create(model, lr=TRAIN_LR)
    kernels.reset_launch_counts()
    losses = [step(state, x, labels)[0]]
    sync()
    launches = dict(kernels.launch_counts)
    print(f"  launches per non-fused train step: {launches}", flush=True)
    want = {k: 14 if k in GN_KERNELS else 0 for k in launches}
    check(launches == want, f"launches per step {launches}, expected {want}")
    for _ in range(WARMUP - 1):
        losses.append(step(state, x, labels)[0])
    losses[-1].item()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    for _ in range(STEPS):
        losses.append(step(state, x, labels)[0])
    curve = torch.stack(losses).cpu()
    dt = time.perf_counter() - t
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = dt / STEPS * 1e3
    print(f"train step 96^3 flagship bf16, non-fused: {step_ms:.2f} ms/step, "
          f"{np.prod(VOLUME) * STEPS / dt:.1f} voxels/s, peak device memory "
          f"{peak_gb:.2f} GB ({STEPS} steps after {WARMUP} warm-up)", flush=True)
    print("  loss by step: " + ", ".join(f"{v:.4f}" for v in curve.tolist()),
          flush=True)
    check(bool(torch.isfinite(curve).all()), "non-finite loss")
    check(curve[-1].item() < curve[0].item(), "non-fused loss did not fall")

    profile_step(lambda: step(state, x, labels), "one non-fused step", 15)

    # dropout 0.1 at batch 2: one batched forward, a finite loss
    dmodel = nonfused_model(dev, dropout=0.1)
    x2, l2 = torch.cat([x, x.flip(1)]), torch.cat([labels, labels.flip(1)])
    kernels.reset_launch_counts()
    dloss = make_train_step(dmodel, CLASSES)(
        TrainState.create(dmodel, lr=TRAIN_LR), x2, l2)[0].item()
    print(f"  dropout 0.1, batch 2: loss {dloss:.4f}, launches "
          f"{ {k: kernels.launch_counts[k] for k in GN_KERNELS} }", flush=True)
    check(np.isfinite(dloss), "dropout step: non-finite loss")
    del dmodel
    stats = dict(step_ms=step_ms, peak_gb=peak_gb, loss_first=curve[0].item(),
                 loss_last=curve[-1].item(), at_init=at_init)
    return launches, stats, model, step, x, labels


def gn_bound(name, x3, groups):
    """The least time of one GroupNorm launch: bytes (each input read once,
    each output written once) over 3.35 TB/s against f32 operations over
    67 TFLOP/s (3, 3, 5 and 7 per element for stats, apply, reduce, dx)."""
    n, s, c = x3.shape
    big = float(n * s * c * x3.element_size())
    small = 4.0 * n * groups
    nbytes, ops = {
        "gn_stats": (big + 2 * small, 3.0),
        "gn_apply": (2 * big + 2 * small + 8.0 * c, 3.0),
        "gn_bwd_reduce": (2 * big + 4 * small + 12.0 * c, 5.0),
        "gn_bwd_dx": (3 * big + 4 * small + 4.0 * c, 7.0),
    }[name]
    return max(ops * n * s * c / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3


def gn_library_args(x3, scale, bias):
    """PyTorch's GroupNorm operands for the (N, S, C) slab of a cubic
    volume: the channels-first view of its channels-last memory (5-D, so
    ``channels_last_3d``) and the affine in the input's dtype, as the
    library takes it."""
    n, s, c = x3.shape
    e = round(s ** (1 / 3))
    check(e ** 3 == s, f"slab of {s} voxels is not a cube")
    v = x3.view(n, e, e, e, c).permute(0, 4, 1, 2, 3)
    return v, scale.to(x3.dtype), bias.to(x3.dtype), (n, c, s)


def gn_operands(name, args):
    """(x3, groups, scale, bias) of a recorded call of a GroupNorm
    dispatcher (``gn_stats(x3, G, eps)``, ``gn_apply(x3, mean, inv, scale,
    bias)``, ``gn_bwd_reduce(x3, g3, mean, inv, scale)``, ``gn_bwd_dx(x3,
    g3, mean, inv, scale, sdx, sdxx)``); the affine is the identity where
    the call has none."""
    x3 = args[0]
    ones = torch.ones(x3.shape[-1], device=x3.device)
    if name == "gn_stats":
        return x3, int(args[1]), ones, ones * 0
    if name == "gn_apply":
        return x3, int(args[1].shape[1]), args[3], args[4]
    return x3, int(args[2].shape[1]), args[4], ones * 0


def gn_library_call(name, args, view=False):
    """One PyTorch call computing the same function (a yardstick; the port
    never calls it): ``F.group_norm`` for gn_stats and gn_apply (the whole
    forward), and ``aten.native_group_norm_backward`` for gn_bwd_reduce
    and gn_bwd_dx (dx, dscale and dbias together), each on contiguous
    channels-first copies of x (and g), made here, before timing, and not
    in its time. ``view``: ``F.group_norm`` on the channels-first view of
    x's channels-last memory instead, as this phase timed it before (its
    moments then run over strided rows)."""
    x3, groups, scale, bias = gn_operands(name, args)
    v, w, b, (n, c, s) = gn_library_args(x3, scale, bias)
    if view:
        return lambda: F.group_norm(v, groups, w, b, 1e-5)
    vc = v.contiguous()
    if name in ("gn_stats", "gn_apply"):
        return lambda: F.group_norm(vc, groups, w, b, 1e-5)
    gc = args[1].view(v.permute(0, 2, 3, 4, 1).shape).permute(
        0, 4, 1, 2, 3).contiguous()
    _, mean, rstd = torch.ops.aten.native_group_norm(vc, w, b, n, c, s, groups,
                                                      1e-5)
    return lambda: torch.ops.aten.native_group_norm_backward(
        gc, vc, mean, rstd, w, n, c, s, groups, [True, True, True])


def gn_check_call(name, out_k, out_p, what):
    """A recorded launch against its plain version at phase 12's bars;
    returns the max |error|."""
    if name == "gn_stats":
        for k, p in zip(out_k, out_p):
            torch.testing.assert_close(k, p, rtol=1e-4, atol=0,
                                       msg=lambda m: f"gn_stats ({what}): {m}")
        return max((k - p).abs().max().item() for k, p in zip(out_k, out_p))
    if name == "gn_apply":
        torch.testing.assert_close(out_k.float(), out_p.float(), rtol=2 ** -7,
                                   atol=1e-3,
                                   msg=lambda m: f"gn_apply ({what}): {m}")
        return (out_k.float() - out_p.float()).abs().max().item()
    if name == "gn_bwd_reduce":
        return max(check_grad(k, p, 1e-3, f"gn_bwd_reduce ({what})")
                   for k, p in zip(out_k, out_p))
    return check_grad(out_k, out_p, 2 ** -7, f"gn_bwd_dx ({what})")


def phase_gn_timing(model, step, x, labels):
    """Every GroupNorm launch of one non-fused training step (its forward
    and its backward), recorded at lr 0, held to its plain version and
    timed as phase 6 does, against one library call and its bound; the
    forward's launches also against ``F.group_norm`` on the channels-last
    view (``library_view_ms``). gn_stats' and gn_bwd_reduce's ticket
    memset (one int zeroed by the wrapper's workspace allocation) is
    timed at each layer on gn_stats' row: ahead of the layer's gn_apply
    launch, less that launch alone (``memset_ms``: what it adds to a
    kernel's time), and as a graph of its own (``memset_alone_ms``). Once,
    at 96^3 x 64, the library calls are profiled to show what they launch
    (layout copies included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from unetsulc_tpu_torch import kernels
    from unetsulc_tpu_torch.train.step import TrainState

    calls = []
    with recording(calls, GN_KERNELS):
        step(TrainState.create(model, lr=0.0), x, labels)
    sync()
    check(len(calls) == 4 * 14, f"{len(calls)} GroupNorm launches recorded")
    plain_of = plain_fns()
    rows = {n: [] for n in GN_KERNELS}
    shown = set()
    with torch.no_grad():
        for name, args, kw in calls:
            x3, groups, _, _ = gn_operands(name, args)
            kern = lambda: dispatcher(name)(*args, **kw)  # noqa: E731
            plain = lambda: plain_of[name](*args)  # noqa: E731
            fwd = name in ("gn_stats", "gn_apply")  # one library call each
            lib = gn_library_call(name, args)
            libs = {"contiguous": lib}
            if fwd:
                libs["view"] = gn_library_call(name, args, view=True)
            shape = f"{int(x3.shape[2])} @{int(x3.shape[1])} voxels"
            err = gn_check_call(name, kern(), plain(), shape)
            sync()
            if tuple(x3.shape[1:]) == (96 ** 3, 64) and fwd not in shown:
                shown.add(fwd)
                for how, call in libs.items():
                    call()
                    sync()
                    # two calls: the profiler may miss a launch's record
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        call()
                        call()
                        sync()
                    ks = [f"{e.count}x {e.key[:100]} "
                          f"{e.self_device_time_total / 1e3:.3f} ms"
                          for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA]
                    print(f"  two library calls of {name} at 96^3 x 64 "
                          f"({how}) launch:\n    " + "\n    ".join(ks),
                          flush=True)
            row = timed_row(name, shape, kern, plain, lib,
                            gn_bound(name, x3, groups), err)
            if fwd:
                row["library_view_ms"] = graph_ms(libs["view"])
            if name == "gn_apply":
                # this layer's gn_stats row came just before
                n, s, c = (int(v) for v in x3.shape)
                code = 0 if x3.dtype == torch.bfloat16 else 1
                sms = torch.cuda.get_device_properties(
                    x3.device).multi_processor_count
                alloc = lambda: kernels._gn_workspace(  # noqa: E731
                    "gn_stats", n, s, c, groups, code, sms, x3.device)
                rows["gn_stats"][-1].update(
                    memset_ms=graph_ms(lambda: (alloc(), kern()))
                    - graph_ms(kern),
                    memset_alone_ms=graph_ms(alloc))
            rows[name].append(row)
    gn_layer_shares(rows)
    return rows


def gn_layer_shares(rows):
    """Print each GroupNorm layer's launch of every GroupNorm kernel:
    time, bound and share of the bound, as phases 6, 10 and 18 print the
    conv kernels by level, and the ticket memset (inside the times of
    gn_stats and gn_bwd_reduce, which each zero one int); then the
    forward's library times. The forward launches come in GN_LAYERS'
    order, the backward's in reverse."""
    for i, (layer, ext, c) in enumerate(GN_LAYERS):
        cells = []
        for name in GN_KERNELS:
            rs = rows[name]
            r = rs[i] if name in ("gn_stats", "gn_apply") else rs[-1 - i]
            check(r["shape"] == f"{c} @{ext ** 3} voxels",
                  f"{name}'s launch for {layer} is {r['shape']}")
            cells.append(f"{name} {r['ms']:.4f} ms / {r['bound_ms']:.4f} "
                         f"({r['bound_ms'] / r['ms'] * 100:.1f}%)")
        st = rows["gn_stats"][i]
        print(f"  {layer} {ext}^3 x {c}: " + ", ".join(cells)
              + f"; ticket memset {st['memset_ms']:.4f} ms ahead of a kernel "
              f"({st['memset_alone_ms']:.4f} ms as a graph alone)", flush=True)
    fwd = [sum(r[k] for r in rows["gn_stats"]) for k in
           ("ms", "library_ms", "library_view_ms")]
    fwd[0] += sum(r["ms"] for r in rows["gn_apply"])
    print(f"  GroupNorm forward (gn_stats + gn_apply, 14 layers): "
          f"{fwd[0]:.4f} ms; F.group_norm {fwd[1]:.4f} ms on contiguous "
          f"channels-first copies, {fwd[2]:.4f} ms on the channels-last "
          f"view", flush=True)


# ---------------------------------------------------------------------------
# the spatial-parallel path: halo modes of kernels A, C, D (phases 16-18)
# ---------------------------------------------------------------------------

HALO_KERNELS = ["conv3x3x3_fwd_halo", "conv3x3x3_dx_halo",
                "conv3x3x3_wgrad_halo"]
SPACES = (2, 4)
# launches per sp train step of the flagship on bench.py's batch, as PERF.md
# §6 predicts them from the partition: slabs of S = 48 (space 2) and
# 24 (space 4) planes both shard levels 0-2, so only encoder 3 (2 convs, its
# pool) runs unsharded, on the mesh's home device
SP_LAUNCHES = {
    n: dict(conv3x3x3_fwd_halo=11 * n, conv3x3x3_dx_halo=14 * n,
            conv3x3x3_wgrad_halo=14 * n, conv3x3x3_fwd=2, conv3x3x3_dx=2,
            conv3x3x3_wgrad=2, max_pool_buf_fwd=1, max_pool_buf_bwd=1)
    for n in SPACES
}


def halo_planes(g, c, present, gen, dev):
    """Two post-ReLU-like (Yp, Zp, c) bf16 neighbour planes with a zero
    (y, z) ring; None where ``present`` says the ring plane is invalid."""
    out = []
    for ok in present:
        v = torch.relu(torch.randn((g.Y, g.Z, c), generator=gen, device=dev))
        out.append(F.pad(v, (0, 0, 1, 1, 1, 1)).to(torch.bfloat16).contiguous()
                   if ok else None)
    return tuple(out)


def check_halo_dx(out_k, out_p, what):
    """Kernel C's halo mode against its plain version: dx, the two halo
    planes' dx and the sums at kernel C's bars, the ring planes of dx 0."""
    (dk, sk, lk, hk), (dp, sp_, lp, hp) = out_k, out_p
    err = max(check_grad(a, b, 2 ** -7, f"kernel C halo {n} ({what})")
              for a, b, n in ((dk, dp, "dx"), (lk, lp, "dlo"), (hk, hp, "dhi")))
    check_grad(sk, sp_, 1e-3, f"kernel C halo sums ({what})")
    check(not (dk[0].any() or dk[-1].any()),
          f"kernel C halo: dx ring planes not zero ({what})")
    return err


def halo_check_cases(s0=48, p1=12, yz0=96, yz1=49):
    """Phase 16's launches: (name, slab extent, input channels, output
    channels, valid_in, valid_out). Level 0 at space 2: S = 48 planes of 96
    x 96, an edge shard on either side and an interior one; level 1 in the
    slab+E layout at space 4: P = 12 (X = 13, Xp = 15) planes of 49 x 49,
    the last shard and an inner one."""
    return [
        ("enc0.conv2 32->64, left edge", (s0, yz0, yz0), [32], 64,
         [0] + [1] * (s0 + 1), None),
        ("32->32, right edge", (s0, yz0, yz0), [32], 32, [1] * (s0 + 1) + [0],
         None),
        ("dec2.conv1 64+128->64, interior", (s0, yz0, yz0), [64, 128], 64,
         [1] * (s0 + 2), None),
        ("enc1.conv2 64->128, slab+E last shard", (p1 + 1, yz1, yz1), [64],
         128, [1] * (p1 + 2) + [0], [0] + [1] * (p1 + 1) + [0]),
        ("dec1.conv1 128+256->128, slab+E inner shard", (p1 + 1, yz1, yz1),
         [128, 256], 128, [1] * (p1 + 3), [0] + [1] * p1 + [0, 0]),
        # kernels C and D's tile edges: channels not multiples of 64
        ("edges 96+160->48, slab+E first shard", (p1 + 1, yz1, yz1),
         [96, 160], 48, [0] + [1] * (p1 + 2), [0] + [1] * (p1 + 1) + [0]),
    ]


@torch.no_grad()
def phase_halo_checks(dev, cases=None):
    """Kernels A, C and D in halo mode against their plain versions at the
    flagship's slab shapes (:func:`halo_check_cases`). Bars: phase 3's for
    A, phase 8's for C and D, and the planes valid_out drops exactly 0.
    Returns each mode's max |error|."""
    from unetsulc_tpu_torch.ops import conv_fused as cf

    gen = torch.Generator(device=dev).manual_seed(16)
    worst = {k: 0.0 for k in HALO_KERNELS}
    for name, ext, cins, cout, vin, vout in cases or halo_check_cases():
        g = cf.make_geom(*ext)
        xs = [rand_buffer(g, c, gen, dev) for c in cins]
        halos = [halo_planes(g, c, (vin[0], vin[-1]), gen, dev) for c in cins]
        affs = [rand_affine(c, gen, dev) for c in cins]
        w = torch.randn((cout, sum(cins), 3, 3, 3), generator=gen,
                        device=dev) * (27 * sum(cins)) ** -0.5
        bias = 0.1 * torch.randn(cout, generator=gen, device=dev)
        valid = torch.tensor(vin, dtype=torch.float32, device=dev)
        vo = None if vout is None else torch.tensor(vout, dtype=torch.float32,
                                                    device=dev)
        kw = dict(halos=halos, valids=[valid] * len(cins), valid_out=vo)
        y, s = cf.conv_fwd(xs, affs, w, bias, g, **kw)
        yp, sp_ = cf.fused_conv_block_plain(xs, affs, w, bias, g, **kw)
        sync()
        torch.testing.assert_close(y.float(), yp.float(), rtol=2 ** -7,
                                   atol=1e-3)
        torch.testing.assert_close(s, sp_, rtol=1e-3, atol=1e-3)
        check(ring_is_zero(y), f"kernel A halo ring not zero ({name})")
        check(bit_equal((y, s), cf.conv_fwd(xs, affs, w, bias, g, **kw)),
              f"kernel A halo: two launches differ ({name})")
        if vout is not None:
            check(not y[vo == 0].any(), f"kernel A halo wrote a dropped plane "
                  f"({name})")
        e_a = (y.float() - yp.float()).abs().max().item()
        worst["conv3x3x3_fwd_halo"] = max(worst["conv3x3x3_fwd_halo"], e_a)
        dconv = rand_grad(g, cout, gen, dev)
        for b in range(len(cins)):
            what = f"{name} branch {b}"
            out_k = cf.conv_dx(dconv, w, cins, b, affs[b], xs[b], g, None,
                               halos[b], valid)
            out_p = cf.conv3x3x3_dx_plain(dconv, w, cins, b, affs[b], xs[b], g,
                                          halos[b], valid)
            wk = cf.conv_wgrad(xs[b], affs[b], dconv, g, halos[b], valid)
            wp = cf.conv3x3x3_wgrad_plain(xs[b], affs[b], dconv, g, halos[b],
                                          valid)
            sync()
            e_c = check_halo_dx(out_k, out_p, what)
            e_d = check_grad(wk, wp, 1e-3, f"kernel D halo ({what})")
            check(bit_equal(out_k, cf.conv_dx(dconv, w, cins, b, affs[b],
                                              xs[b], g, None, halos[b],
                                              valid)),
                  f"kernel C halo: two launches differ ({what})")
            check(bit_equal(wk, cf.conv_wgrad(xs[b], affs[b], dconv, g,
                                              halos[b], valid)),
                  f"kernel D halo: two launches differ ({what})")
            worst["conv3x3x3_dx_halo"] = max(worst["conv3x3x3_dx_halo"], e_c)
            worst["conv3x3x3_wgrad_halo"] = max(worst["conv3x3x3_wgrad_halo"],
                                                e_d)
        print(f"  {name} @{'x'.join(map(str, ext))}: A max|dy| {e_a:.3g}; "
              f"C {e_c:.3g}; D {e_d:.3g} (last branch)", flush=True)
    return worst


def sp_mesh(n):
    """n shards, all on the one card."""
    from unetsulc_tpu_torch.parallel import make_mesh

    return make_mesh(space=n, devices=[torch.device("cuda")] * n)


def step_grads(model, step_fn, args):
    """(loss, counts, gradients) of one step at lr 0 (the state stays)."""
    from unetsulc_tpu_torch.train.step import TrainState

    loss, counts = step_fn(TrainState.create(model, lr=0.0), *args)
    sync()
    return loss.item(), counts, {n: p.grad.detach().clone()
                                 for n, p in model.named_parameters()}


def phase_sp_train(dev, single_peak_gb):
    """The spatial-parallel train step of the flagship (seed 0) on phase
    9's batch at space 2 and 4, all shards on this card: against the
    single-device fused step from the same state at phase 9's bars; halo
    launches per step against SP_LAUNCHES; 3 warm-up and 20 timed steps; a
    falling loss; peak memory beside the single-device step's; one sp eval
    step. Returns per space the launches and numbers, and the space-2
    model, step and slabs for phase 18."""
    from unetsulc_tpu_torch import kernels
    from unetsulc_tpu_torch.models.unet3d import UNet3D
    from unetsulc_tpu_torch.parallel import shard_x
    from unetsulc_tpu_torch.train.step import (TrainState, make_eval_step_sp,
                                               make_train_step,
                                               make_train_step_sp)

    x, labels = make_batch(dev)
    out, keep = {}, None
    for n in SPACES:
        model = UNet3D(in_channels=1, out_channels=CLASSES,
                       init_channel_number=64, device=dev, seed=0)
        mesh = sp_mesh(n)
        print(f"  space {n}: mesh devices {[str(d) for d in mesh.devices]}: "
              f"the {n} shards run one after another on this one card, so "
              "the step time is not a scaling figure", flush=True)
        xs, ls = shard_x(x, mesh), shard_x(labels, mesh)
        step = make_train_step_sp(model, CLASSES, mesh, momentum=0.9)
        single = make_train_step(model, CLASSES, momentum=0.9)
        l1, c1, g1 = step_grads(model, single, (x, labels))
        _, _, g1b = step_grads(model, single, (x, labels))
        l2, c2, g2 = step_grads(model, step, (xs, ls))
        _, _, g2b = step_grads(model, step, (xs, ls))
        check(all(torch.equal(g1[k], g1b[k]) and torch.equal(g2[k], g2b[k])
                  for k in g1),
              f"space {n}: two steps from one state differ (the kernels are "
              "deterministic)")
        print(f"  space {n}: loss {l2:.6f} vs single-device {l1:.6f} (rel "
              f"{abs(l2 - l1) / abs(l1):.2e}); confusion counts equal: "
              f"{bool(torch.equal(c1, c2))}", flush=True)
        d = param_distances(g2, g1)
        gcos = global_cosine(g2, g1)
        for label, dd, gc in (("single-device step vs itself",
                               param_distances(g1b, g1), global_cosine(g1b, g1)),
                              ("sp step vs single-device step", d, gcos)):
            c, cn, e, en = worst(dd)
            print(f"    {label}: all-parameter cosine {gc:.6f}; worst cosine "
                  f"{1.0 - c:.6f} ({cn}); worst max|dg| / max|g| {e:.4f} "
                  f"({en})", flush=True)
        c, _, e, _ = worst(d)
        check(abs(l2 - l1) <= LOSS_RTOL * abs(l1),
              f"space {n}: loss differs from the single-device step")
        check(gcos >= GLOBAL_COS, f"space {n}: all-parameter cosine {gcos}")
        check(1.0 - c >= GRAD_COS, f"space {n}: gradient cosine {1.0 - c}")
        check(e <= GRAD_ERR, f"space {n}: gradient error {e}")

        state = TrainState.create(model, lr=TRAIN_LR)
        kernels.reset_launch_counts()
        losses = [step(state, xs, ls)[0]]
        sync()
        launches = dict(kernels.launch_counts)
        print(f"  space {n}: launches per sp train step: {launches}",
              flush=True)
        want = {k: 0 for k in launches}
        want.update(SP_LAUNCHES[n])
        check(launches == want, f"space {n}: launches {launches}, predicted "
              f"{want}")
        for _ in range(WARMUP - 1):
            losses.append(step(state, xs, ls)[0])
        losses[-1].item()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        for _ in range(STEPS):
            losses.append(step(state, xs, ls)[0])
        curve = torch.stack(losses).cpu()
        dt = time.perf_counter() - t
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        held_gb = torch.cuda.memory_allocated() / 1e9
        step_ms = dt / STEPS * 1e3
        # the single-device step's peak measured the same way, from the
        # same state and with the same allocations held (earlier phases
        # leave some: phase 9's number is not like with like)
        torch.cuda.reset_peak_memory_stats()
        single(state, x, labels)
        sync()
        here_gb = torch.cuda.max_memory_allocated() / 1e9
        print(f"sp train step 96^3 flagship bf16, space {n} on one card: "
              f"{step_ms:.2f} ms/step, peak device memory {peak_gb:.2f} GB "
              f"against {here_gb:.2f} GB for the single-device step measured "
              f"here ({held_gb:.2f} GB allocated between steps; phase 9's "
              f"single-device peak {single_peak_gb:.2f} GB; {STEPS} steps "
              f"after {WARMUP} warm-up)", flush=True)
        print("  loss by step: " + ", ".join(f"{v:.4f}" for v in curve.tolist()),
              flush=True)
        check(bool(torch.isfinite(curve).all()), f"space {n}: non-finite loss")
        check(curve[-1].item() < curve[0].item(),
              f"space {n}: loss did not fall")
        profile_step(lambda: step(state, xs, ls), f"one space-{n} sp step", 12)
        el, ec = make_eval_step_sp(model, CLASSES, mesh)(xs, ls)
        sync()
        n_valid = int((labels != -1).sum().item())
        print(f"  space {n}: sp eval step loss {el.item():.4f}, "
              f"{int(ec[0].sum() + ec[2].sum())} labelled voxels counted "
              f"({n_valid} labelled)", flush=True)
        check(bool(torch.isfinite(el)), f"space {n}: non-finite eval loss")
        check(int(ec[0].sum() + ec[2].sum()) == n_valid,
              f"space {n}: eval counts do not cover the labelled voxels")
        out[n] = dict(launches=launches, step_ms=step_ms, peak_gb=peak_gb,
                      single_peak_gb=here_gb, held_gb=held_gb,
                      loss_first=curve[0].item(), loss_last=curve[-1].item(),
                      eval_loss=el.item(), loss_rel=abs(l2 - l1) / abs(l1),
                      global_cos=gcos, cos=1.0 - c, err=e)
        if n == SPACES[0]:
            keep = (model, step, xs, ls)
        else:
            del model, step
    return out, keep


def halo_filled_normalized(x, aff, halo, valid, g):
    """The (1, C, Xp, Y, Z) channels-last input of a library conv: the
    halo-filled input normalized under its validity."""
    from unetsulc_tpu_torch.ops import conv_fused as cf

    v = torch.where(cf.halo_mask(g, valid),
                    cf.apply_affine(cf.halo_filled(x, halo), aff), 0)
    return channels_last_5d(v[:, 1:1 + g.Y, 1:1 + g.Z])


def halo_bound(kind, xs, cout, g, planes):
    """The least time of one halo-mode launch: ``planes`` output planes
    that the run needs (kernel A: those valid_out keeps; C: the valid ones
    of the X+2; D: the X interior ones), 2 x voxels x 27 x Cin x Cout
    operations at the bf16 peak against the bytes read once (inputs'
    interiors and halo planes) and written once (kernel C: dx with its ring
    and both halo planes' dx; D: the f32 dW)."""
    cin = sum(int(x.shape[3]) for x in xs)
    vox_in = (g.X + 2) * g.Y * g.Z
    vox_out = planes * g.Y * g.Z
    plane_p = g.Yp * g.Zp
    flops = 2.0 * vox_out * 27 * cin * cout
    w_bytes = 2.0 * 27 * cin * cout
    if kind == "conv3x3x3_fwd_halo":
        nbytes = 2.0 * (vox_in * cin + g.Xp * plane_p * cout) + w_bytes
    elif kind == "conv3x3x3_dx_halo":
        nbytes = 2.0 * (g.X * g.Y * g.Z * cout + vox_in * cin
                        + (g.Xp + 2) * plane_p * cin) + w_bytes
    else:
        nbytes = 2.0 * (vox_in * cin + g.X * g.Y * g.Z * cout) \
            + 4.0 * 27 * cin * cout
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3


def timed_halo_row(name, shape, kern, nohalo, plain, lib, bound, err):
    """One halo launch's row: kernel, the same launch without halo, the
    plain version and the library call, each captured as a CUDA graph and
    timed in turns (plain, kernel, no-halo, library, kernel; three times),
    medians in ms."""
    graphs = [capture(f) for f in (plain, kern, nohalo, lib)]
    sync()
    ms = {k: [] for k in ("plain", "kern", "nohalo", "lib")}
    for _ in range(3):
        for key, gr in zip(("plain", "kern", "nohalo", "lib", "kern"),
                           graphs + [graphs[1]]):
            ms[key].append(event_ms(gr, REPS))
    del graphs
    row = dict(shape=shape, ms=statistics.median(ms["kern"]),
               nohalo_ms=statistics.median(ms["nohalo"]),
               plain_ms=statistics.median(ms["plain"]),
               library_ms=statistics.median(ms["lib"]), bound_ms=bound,
               max_abs_err=err)
    print(f"  {name} {shape}: kernel {row['ms']:.4f} ms "
          f"({bound / row['ms'] * 100:.1f}% of its bound), without halo "
          f"{row['nohalo_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
          f"library {row['library_ms']:.4f} ms, bound {bound:.4f} ms, "
          f"max|err| {err:.3g}", flush=True)
    return row


def phase_halo_timing(model, step, xs, ls):
    """Every halo-mode launch of one space-2 sp training step (recorded at
    lr 0), held to its plain version at phase 16's bars and timed against
    the same launch without halo (which reads the buffer's own zero ring
    planes), its plain version, one library call on the halo-filled slab
    (cuDNN conv3d with padding (0, 1, 1); ``aten.convolution_backward``
    with that padding for dx and for dW; bf16, channels-last) and its
    bound."""
    from unetsulc_tpu_torch.ops import conv_fused as cf
    from unetsulc_tpu_torch.train.step import TrainState

    names = ["conv3x3x3_fwd", "conv3x3x3_dx", "conv3x3x3_wgrad"]
    calls = []
    with recording(calls, names):
        step(TrainState.create(model, lr=0.0), xs, ls)
    sync()
    plain_of = plain_fns()
    rows = {k: [] for k in HALO_KERNELS}
    with torch.no_grad():
        for name, args, kw in calls:
            if name == "conv3x3x3_fwd":
                if kw.get("valids") is None:
                    continue
                xs_, affs, w, b, g, packed = args[:6]
                kern = lambda: cf.conv_fwd(*args, **kw)  # noqa: E731
                nohalo = lambda: cf.conv_fwd(xs_, affs, w, b, g, packed)  # noqa: E731
                plain = lambda: plain_of[name](*args, **kw)  # noqa: E731
                xn = torch.cat([halo_filled_normalized(x, a, h, v, g)
                                for x, a, h, v in zip(xs_, affs, kw["halos"],
                                                      kw["valids"])], 1)
                wl = w.to(torch.bfloat16).contiguous(
                    memory_format=torch.channels_last_3d)
                bl = b.to(torch.bfloat16)
                lib = lambda: F.conv3d(xn, wl, bl, padding=(0, 1, 1))  # noqa: E731
                vo = kw["valid_out"]
                planes = g.X if vo is None else int(vo.sum().item())
                kind, cout = "conv3x3x3_fwd_halo", int(w.shape[0])
                bound = halo_bound(kind, xs_, cout, g, planes)
                shape = (f"{'+'.join(str(int(v.shape[3])) for v in xs_)}->"
                         f"{cout} @{g.X}x{g.Y}x{g.Z}")
                (yk, sk), (yp, sp_) = kern(), plain()
                sync()
                torch.testing.assert_close(yk.float(), yp.float(),
                                           rtol=2 ** -7, atol=1e-3)
                torch.testing.assert_close(sk, sp_, rtol=1e-3, atol=1e-3)
                err = (yk.float() - yp.float()).abs().max().item()
                del yk, sk, yp, sp_
            else:
                n_pos = 10 if name == "conv3x3x3_dx" else 6
                if len(args) < n_pos or args[n_pos - 1] is None:
                    continue
                kern = lambda: dispatcher(name)(*args)  # noqa: E731
                nohalo = lambda: dispatcher(name)(*args[:n_pos - 2])  # noqa: E731
                plain = lambda: plain_of[name](*args)  # noqa: E731
                if name == "conv3x3x3_dx":
                    dconv, w, cins, br, aff, xb, g, _, halo, valid = args
                    c0 = sum(cins[:br])
                    wb = w[:, c0:c0 + cins[br]]
                    ci, co, mask = cins[br], int(w.shape[0]), [True, False, False]
                    kind = "conv3x3x3_dx_halo"
                    planes = int(valid.sum().item())
                else:
                    xb, aff, dconv, g, halo, valid = args
                    ci, co = int(xb.shape[3]), int(dconv.shape[3])
                    wb = torch.zeros((co, ci, 3, 3, 3), device=xb.device)
                    mask, kind, planes = [False, True, False], \
                        "conv3x3x3_wgrad_halo", g.X
                inp = halo_filled_normalized(xb, aff, halo, valid, g)
                go = channels_last_5d(cf.unpad_from_geom(dconv, g)[0])
                wl = wb.to(torch.bfloat16).contiguous(
                    memory_format=torch.channels_last_3d)
                lib = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
                    go, inp, wl, None, [1, 1, 1], [0, 1, 1], [1, 1, 1], False,
                    [0, 0, 0], 1, mask)
                bound = halo_bound(kind, [xb], co, g, planes)
                shape = f"{ci}x{co} @{g.X}x{g.Y}x{g.Z}"
                out = kern()
                if name == "conv3x3x3_dx":
                    err = check_halo_dx(out, plain(), shape)
                else:
                    err = check_grad(out, plain(), 1e-3,
                                     f"kernel D halo {shape}")
                check(bit_equal(out, kern()),
                      f"{kind}: two launches differ ({shape})")
            sync()
            rows[kind].append(timed_halo_row(kind, shape, kern, nohalo, plain,
                                             lib, bound, err))
    for kind in HALO_KERNELS:
        level_shares(kind, rows[kind])
    return rows


# ---------------------------------------------------------------------------
# the matrix-unit probe (phases 19-20) and the training CLI (phase 21)
# ---------------------------------------------------------------------------

PROBE_KERNELS = ["mxu_dot", "mxu_rdot", "slab_build"]
PROBE_REPLACES = {"mxu_dot": "scripts/mxu_probe.py:24",
                  "mxu_rdot": "scripts/mxu_probe.py:56",
                  "slab_build": "scripts/mxu_probe.py:89"}
# graph replays between one pair of CUDA events, per timed turn of a probe
# launch (each launch already runs 200 dots or builds)
PROBE_REPS = 3
# the highest share of its bound a probe launch may read (timing noise
# above 100%)
PROBE_MAX_SHARE = 1.05


def probe_cases():
    """(kernel, dims, kernel call, plain call, library call or None, bound
    ms, bound_by) of every probe launch at the JAX script's shapes (ps
    10976, reps 200, its 11 + 6 + 6 combinations). Bounds: the dots'
    operations at the bf16 peak; the build's shared-memory bytes at 128 B
    per clock on each SM at ``clocks.max.sm``."""
    from unetsulc_tpu_torch.tools import mxu_probe as mp

    dev = torch.device("cuda", 0)
    ps, reps = mp.PS, mp.REPS
    clock = mp.max_sm_clock_hz()
    check(clock is not None, "nvidia-smi gave no SM clock")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = []
    for k, n in mp.DOT_COMBOS:
        a, b = mp._const((ps, k), 0.5, dev), mp._const((k, n), 0.5, dev)
        cases.append((
            "mxu_dot", (k, n),
            lambda k=k, n=n: mp.mxu_dot(k, n, ps, reps, dev),
            lambda k=k, n=n: mp.mxu_dot_plain(k, n, ps, reps, dev),
            lambda a=a, b=b: [torch.matmul(a, b) for _ in range(reps)],
            reps * mp.dot_bound_us(ps, k, n) / 1e3, "operations"))
    for m, n in mp.RDOT_COMBOS:
        a, b = mp._const((ps, m), 0.5, dev), mp._const((ps, n), 0.5, dev)
        cases.append((
            "mxu_rdot", (m, n),
            lambda m=m, n=n: mp.mxu_rdot(m, n, ps, reps, dev),
            lambda m=m, n=n: mp.mxu_rdot_plain(m, n, ps, reps, dev),
            lambda a=a, b=b: [torch.matmul(a.t(), b) for _ in range(reps)],
            reps * mp.dot_bound_us(ps, m, n) / 1e3, "operations"))
    for cs, c in mp.BUILD_COMBOS:
        cases.append((
            "slab_build", (cs, c),
            lambda cs=cs, c=c: mp.slab_build(cs, c, ps, reps, dev),
            lambda cs=cs, c=c: mp.slab_build_plain(cs, c, ps, reps, dev),
            None, reps * mp.build_bound_us(cs, c, ps, clock, sms) / 1e3,
            "bytes"))
    return cases


@torch.no_grad()
def phase_probe_checks(dev):
    """Each probe launch against its plain version at the JAX script's
    shapes: o exactly equal for all three, and for the build the whole
    final slab too, and two launches of each dot and rdot combination bit
    for bit. Every product is exact (0.5 * 0.5 in bf16) and every f32 sum
    of the dot kernels, in any order of their atomics, stays exact
    (csrc/mxu_probe.cu, "Exactness"; tests/test_torch_probe_plan.py replays
    the order), so a difference is a bug, rdot included."""
    from unetsulc_tpu_torch.tools import mxu_probe as mp

    errs = {k: 0.0 for k in PROBE_KERNELS}
    for name, dims, kern, plain, _, _, _ in probe_cases():
        if name == "slab_build":
            o, slab = mp.slab_build(*dims, mp.PS, mp.REPS, dev,
                                    return_slab=True)
            po, pslab = mp.slab_build_plain(*dims, mp.PS, mp.REPS, dev,
                                            return_slab=True)
            sync()
            check(torch.equal(slab, pslab),
                  f"slab_build {dims}: the final slab differs from the plain "
                  "version's")
        else:
            o, po, o2 = kern(), plain(), kern()
            sync()
            check(torch.equal(o.view(torch.int32), o2.view(torch.int32)),
                  f"{name} {dims}: two launches differ")
        sync()
        err = float((o - po).abs().max())
        check(torch.equal(o, po), f"{name} {dims}: max |err| {err} against "
              "the plain version (exact expected)")
        again = "" if name == "slab_build" else ", two launches bit-equal"
        print(f"  {name} {dims}: o[0, 0] = {float(o[0, 0]):.1f}, equal to the "
              f"plain version{again}", flush=True)
        errs[name] = max(errs[name], err)
    return errs


def phase_probe(dev):
    """The probe CLI (``tools.mxu_probe.main([])``) with the launch counts
    zeroed just before and read just after (11 / 6 / 6); then every probe
    launch timed against its plain version, ``torch.matmul`` on the same
    bf16 operands from device memory (200 calls: the library's counterpart
    of one launch; none for the build) and its bound, and each dot launch
    at its steady rate (``steady_ms``: 200 reps at the rate of a launch's
    last 100, the launch of 200 less a launch of 100)."""
    from unetsulc_tpu_torch import kernels
    from unetsulc_tpu_torch.tools import mxu_probe as mp

    kernels.reset_launch_counts()
    t = time.time()
    cli_rows = mp.main([])
    counts = {k: kernels.launch_counts[k] for k in PROBE_KERNELS}
    print(f"  probe CLI: {time.time() - t:.1f} s, launches {counts}",
          flush=True)
    want = {"mxu_dot": len(mp.DOT_COMBOS), "mxu_rdot": len(mp.RDOT_COMBOS),
            "slab_build": len(mp.BUILD_COMBOS)}
    check(counts == want, f"probe launches {counts}, expected {want}")
    check(all(r["us"] and r["us"] > 0 for r in cli_rows),
          "the probe CLI measured no time")

    rows = {k: [] for k in PROBE_KERNELS}
    half = mp.REPS // 2
    for name, dims, kern, plain, lib, bound, bound_by in probe_cases():
        gk, gp = capture(kern), capture(plain)
        gl = capture(lib) if lib is not None else None
        # the dots' steady rate: the same launch with half the reps, whose
        # difference leaves out the launch's fixed costs (o's zero fill, the
        # operand fill, the folds, the first and last wave)
        gh = None
        if name != "slab_build":
            fn = mp.mxu_dot if name == "mxu_dot" else mp.mxu_rdot
            gh = capture(lambda fn=fn, dims=dims: fn(*dims, mp.PS, half, dev))
        sync()
        ms_k, ms_p, ms_l, ms_h = [], [], [], []
        for _ in range(3):
            ms_p.append(event_ms(gp, PROBE_REPS))
            ms_k.append(event_ms(gk, PROBE_REPS))
            if gl is not None:
                ms_l.append(event_ms(gl, PROBE_REPS))
            if gh is not None:
                ms_h.append(event_ms(gh, PROBE_REPS))
            ms_k.append(event_ms(gk, PROBE_REPS))
        del gk, gp, gl, gh
        row = dict(shape=dims, ms=statistics.median(ms_k),
                   plain_ms=statistics.median(ms_p),
                   library_ms=statistics.median(ms_l) if ms_l else None,
                   bound_ms=bound, bound_by=bound_by, max_abs_err=0.0)
        steady = ""
        if ms_h:
            row["steady_ms"] = ((row["ms"] - statistics.median(ms_h))
                                * mp.REPS / (mp.REPS - half))
            steady = (f", steady {row['steady_ms'] / mp.REPS * 1e3:.2f} µs "
                      f"per dot ({bound / row['steady_ms'] * 100:.1f}%)")
        lib_txt = ("none" if row["library_ms"] is None
                   else f"{row['library_ms']:.4f} ms")
        print(f"  {name} {dims}: kernel {row['ms']:.4f} ms "
              f"({row['ms'] / mp.REPS * 1e3:.2f} µs per dot or build), plain "
              f"{row['plain_ms']:.4f} ms, library {lib_txt}, bound "
              f"{bound:.4f} ms ({bound_by}): {bound / row['ms'] * 100:.1f}% "
              f"of it{steady}", flush=True)
        # faster than the bound is work left out: the build's slab is a
        # fixed point, so its equality check alone cannot see skipped stores
        check(bound / row["ms"] <= PROBE_MAX_SHARE,
              f"{name} {dims}: {bound / row['ms'] * 100:.1f}% of its bound, "
              f"above {PROBE_MAX_SHARE * 100:.0f}%")
        rows[name].append(row)

    def share(rs, key="ms"):
        return sum(r["bound_ms"] for r in rs) / sum(r[key] for r in rs) * 100

    def total(rs, key):
        return sum(r[key] for r in rs)

    dot, rdot = rows["mxu_dot"], rows["mxu_rdot"]
    n64 = [r for r in dot if r["shape"][1] == 64]
    wide = [r for r in dot if r["shape"][1] >= 128]
    print(f"  probe summary: mxu_dot at {share(n64):.1f}% of its bound at "
          f"n = 64 and {share(wide):.1f}% at n >= 128 (per launch "
          f"{min(share([r]) for r in wide):.1f}-"
          f"{max(share([r]) for r in wide):.1f}%), at the steady rate "
          f"{share(n64, 'steady_ms'):.1f}% and "
          f"{share(wide, 'steady_ms'):.1f}%; mxu_dot "
          f"{total(dot, 'ms'):.3f} ms against torch.matmul "
          f"{total(dot, 'library_ms'):.3f} ms, mxu_rdot "
          f"{total(rdot, 'ms'):.3f} ms against "
          f"{total(rdot, 'library_ms'):.3f} ms (sums over "
          f"{len(dot)} and {len(rdot)} launches)", flush=True)
    return counts, rows


def plain_guard(calls):
    """Record every call of a kernel's plain version that gets a CUDA
    tensor (the dispatchers send CUDA tensors to the kernels only)."""
    from unetsulc_tpu_torch.ops import conv_fused, groupnorm

    fns = [(conv_fused, n) for n in (
        "fused_conv_block_plain", "conv3x3x3_dx_plain",
        "conv3x3x3_wgrad_plain", "max_pool_buf_plain",
        "max_pool_buf_bwd_plain")] + [(groupnorm, n) for n in (
            "gn_stats_plain", "gn_apply_plain", "gn_bwd_reduce_plain",
            "gn_bwd_dx_plain", "gn_sums_plain", "gn_finalize_plain")]

    def cuda_in(v):
        if isinstance(v, torch.Tensor):
            return v.is_cuda
        if isinstance(v, (list, tuple)):
            return any(cuda_in(u) for u in v)
        return False

    def guarded(name, fn):
        def call(*args, **kw):
            if cuda_in(args) or cuda_in(list(kw.values())):
                calls.append(name)
            return fn(*args, **kw)
        return call

    @contextlib.contextmanager
    def ctx():
        saved = [(mod, n, getattr(mod, n)) for mod, n in fns]
        for mod, n, fn in saved:
            setattr(mod, n, guarded(n, fn))
        try:
            yield
        finally:
            for mod, n, fn in saved:
                setattr(mod, n, fn)

    return ctx()


FUSED_KERNELS = ["conv3x3x3_fwd", "max_pool_buf_fwd", "conv3x3x3_dx",
                 "conv3x3x3_wgrad", "max_pool_buf_bwd"]
BACKWARD_KERNELS = ["conv3x3x3_dx", "conv3x3x3_wgrad", "max_pool_buf_bwd"]


@contextlib.contextmanager
def epoch_log(log):
    """Append (phase, launches in the phase, perf, volume extents) for every
    epoch phase that ``learning()`` runs, and print it."""
    from unetsulc_tpu_torch import kernels
    from unetsulc_tpu_torch.method.training import TrainingSulciLabeller

    orig = TrainingSulciLabeller._epoch_pass

    def logged(self, phase, *args, **kw):
        before = dict(kernels.launch_counts)
        out = orig(self, phase, *args, **kw)
        sync()
        launched = {k: kernels.launch_counts[k] - before[k]
                    for k in FUSED_KERNELS}
        loss, _, perf, extents = out
        log.append(dict(phase=phase, loss=loss, launches=launched,
                        seconds=perf["seconds"],
                        voxels_per_sec=perf["voxels_per_sec"],
                        extents=extents))
        print(f"    [{phase}] loss {loss:.4f}, {perf['seconds']:.3f} s, "
              f"{perf['voxels_per_sec']:,.0f} voxels/s, volumes {extents}, "
              f"launches {launched}", flush=True)
        return out

    TrainingSulciLabeller._epoch_pass = logged
    try:
        yield
    finally:
        TrainingSulciLabeller._epoch_pass = orig


def make_cohort(root, n):
    """``n`` synthetic graphs from phase 5's generator as a cohort under
    ``root``; each graph is its own uncut graph."""
    from unetsulc_tpu_torch.io.container import save_graph_npz
    from unetsulc_tpu_torch.io.graph import make_synthetic_graph

    os.makedirs(os.path.join(root, "cohorts"))
    subjects = []
    for i in range(n):
        g = make_synthetic_graph(np.random.default_rng(1000 + i), LABELS,
                                 n_folds_per_label=2, points_per_fold=300,
                                 extent=180)
        path = os.path.join(root, f"subj{i}_L.npz")
        save_graph_npz(g, path)
        subjects.append({"name": f"subj{i}", "t1": None, "roots": None,
                         "skeleton": None, "graph": path,
                         "notcut_graph": path})
    with open(os.path.join(root, "cohorts",
                           "cohort-Flagship6_hemi-L.json"), "w") as f:
        json.dump({"name": "Flagship6", "subjects": subjects}, f)


def check_experiment(wp, name, results, log, folds, schema, launched):
    """The artifact tree of tests/test_experiment.py:84-117, the results
    schema with ``folds`` folds, finite losses, a falling mean loss over
    the folds from epoch 1 to 2, the kernels ``launched`` launched and the
    other fused kernels not."""
    for key in schema:
        check(key in results, f"{name}: results lack {key}")
    check(len(results["lr"]) == folds and len(results["best_acc"]) == folds,
          f"{name}: results hold {len(results['lr'])} folds")
    for key in ("epoch_loss_train", "epoch_loss_val"):
        check(len(results[key]) == folds
              and all(len(c) == 2 for c in results[key]),
              f"{name}: {key} {results[key]}")
    for th, sc in results["threshold_scores"].items():
        check(len(sc) == folds, f"{name}: threshold {th} scores {sc}")
    check(set(results["threshold_scores"]) == {"20", "50"},
          f"{name}: thresholds {sorted(results['threshold_scores'])}")
    check(len(results["tpu"]) == folds and all(
        r["step"] == "single_device" and r["kernels"] == "fused"
        for r in results["tpu"]), f"{name}: routing {results['tpu']}")
    data = os.path.join(wp, "data", "cohort-Flagship6_hemi-L_data.json")
    check(os.path.exists(data), f"{name}: missing {data}")
    for cvi in range(folds):
        for f in (f"{name}_cv{cvi}_model.mdsm", f"{name}_cv{cvi}_params.json"):
            p = os.path.join(wp, "models", name, f)
            check(os.path.exists(p), f"missing {p}")
        tb = os.path.join(wp, "tensorboard", name, f"cv{cvi}")
        check(os.path.isdir(tb) and any(
            n.startswith("events.out.tfevents") for n in os.listdir(tb)),
            f"missing events under {tb}")
    with open(os.path.join(wp, "models", name, f"{name}_params.json")) as f:
        check("cutting_threshold" in json.load(f),
              f"{name}: no cutting_threshold")
    check(os.path.exists(os.path.join(wp, "results", f"{name}_results.json")),
          f"{name}: no results file")
    train = np.asarray(results["epoch_loss_train"], float)
    check(bool(np.isfinite(train).all())
          and bool(np.isfinite(np.asarray(results["epoch_loss_val"])).all()),
          f"{name}: non-finite loss {results['epoch_loss_train']}")
    m1, m2 = train[:, 0].mean(), train[:, 1].mean()
    check(m2 < m1, f"{name}: mean train loss over the folds did not fall "
          f"({m1:.4f} -> {m2:.4f})")
    total = {k: sum(e["launches"][k] for e in log) for k in FUSED_KERNELS}
    check(all((v > 0) == (k in launched) for k, v in total.items()),
          f"{name}: launches {total}, expected launches of {launched} only")
    trains = [e for e in log if e["phase"] == "train"]
    secs = [e["seconds"] for e in trains]
    vps = [e["voxels_per_sec"] for e in trains]
    extents = sorted({x for e in log for x in e["extents"]})
    print(f"  {name}: {folds} folds, mean train loss {m1:.4f} -> {m2:.4f}; "
          f"train phase {statistics.median(secs):.3f} s per epoch (median; "
          f"{min(secs):.3f}-{max(secs):.3f}), {statistics.median(vps):,.0f} "
          f"voxels/s (median); volumes used {extents}; launches in all "
          f"{total}", flush=True)
    return dict(train_s=statistics.median(secs),
                voxels_per_sec=statistics.median(vps), extents=extents,
                launches=total)


def phase_experiment(dev):
    """The training CLI end to end on the card, in process: a 3-fold CV
    experiment of the flagship (init 64, bf16, 'crg', interpolating) on six
    synthetic 96^3 graphs, 2 epochs, batch 1 (per-sample cubic buckets),
    SGD lr 0.01, momentum 0.9, thresholds 20 and 50; then a transfer
    experiment from its cv0 model (final_conv only, then the decoders once
    FineTunning fires: kernels A-D, no E). Launches per epoch phase are
    printed; no plain version may get a CUDA tensor."""
    from unetsulc_tpu_torch import kernels
    from unetsulc_tpu_torch import main as port_main

    root = os.path.join(WORK, "experiment")
    shutil.rmtree(root, ignore_errors=True)
    make_cohort(root, 6)
    base = {"working_path": root, "cohort_name": "Flagship6", "hemi": "L",
            "cuda": 0, "batch_size": 1, "lr": TRAIN_LR, "momentum": 0.9,
            "n_cvinner": 3, "n_epochs": 2, "th_range": [20, 50]}
    train_params = {**base, "learning": "training",
                    "dict_model": {"name": "FlagshipCV", "num_filter": 64}}
    model_dir = os.path.join(root, "models", "FlagshipCV")
    transfer_params = {
        **base, "learning": "transfer_learning",
        "dict_model": {"name": "FlagshipTL", "num_filter": 64},
        "dict_trained_model": {
            "model_file": os.path.join(model_dir, "FlagshipCV_cv0_model.mdsm"),
            "out_channels": os.path.join(model_dir,
                                         "FlagshipCV_cv0_params.json"),
            "init_channel_number": 64},
        "patience": {"fine_tunning": 1}}
    schema_train = ["lr", "momentum", "batch_size", "num_epochs",
                    "graphs_train", "graphs_test", "patience",
                    "epoch_loss_val", "epoch_acc_val", "epoch_loss_train",
                    "epoch_acc_train", "best_acc", "best_epoch",
                    "divide_lr_epoch", "duration", "threshold_scores", "tpu"]
    schema_transfer = ["lr", "momentum", "batch_size", "num_epoch",
                       "fine_tunning_epoch", "graphs_train", "graphs_test",
                       "patience", "epoch_loss_val", "epoch_acc_val",
                       "epoch_loss_train", "epoch_acc_train", "best_acc",
                       "best_epoch", "duration", "threshold_scores", "tpu"]
    out = {}
    # the transfer experiment trains final_conv and then the decoders, no
    # layer below a pool: kernel E (the pool backward) never runs there
    for name, params, schema, launched in (
            ("FlagshipCV", train_params, schema_train, FUSED_KERNELS),
            ("FlagshipTL", transfer_params, schema_transfer,
             FUSED_KERNELS[:4])):
        path = os.path.join(root, f"{name}_parameters.json")
        with open(path, "w") as f:
            json.dump(params, f)
        log, bad = [], []
        kernels.reset_launch_counts()
        t = time.time()
        with epoch_log(log), plain_guard(bad):
            results = port_main.main(["-p", path])
        sync()
        wall = time.time() - t
        check(not bad, f"{name}: plain versions got CUDA tensors: "
              f"{sorted(set(bad))}")
        check(not any(kernels.launch_counts[k] for k in GN_KERNELS),
              f"{name}: the fused flagship launched a GroupNorm kernel")
        out[name] = check_experiment(root, name, results, log,
                                     params["n_cvinner"], schema, launched)
        out[name].update(wall_s=wall, results=results, params=params,
                         main_launches={k: kernels.launch_counts[k]
                                        for k in FUSED_KERNELS})
        print(f"  {name}: main() took {wall:.1f} s", flush=True)
        if name == "FlagshipTL":
            # fold 0 trains final_conv only (no backward kernel) until the
            # forced unfreeze after its last epoch; later folds train the
            # decoders too (the reference's cross-fold semantics)
            fold0 = [e for e in log if e["phase"] == "train"][:2]
            check(all(e["launches"][k] == 0 for e in fold0
                      for k in BACKWARD_KERNELS),
                  "a final_conv-only epoch launched a backward kernel")
            later = [e for e in log if e["phase"] == "train"][2:]
            check(all(e["launches"]["conv3x3x3_dx"] > 0 for e in later),
                  "a fine-tuning epoch launched no kernel C")
            check(results["fine_tunning_epoch"][:1] == [1],
                  f"fine_tunning_epoch {results['fine_tunning_epoch']}")
    return out


# ---------------------------------------------------------------------------
# data and fold parallelism on one card, the CV train phase in parts
# (phase 22)
# ---------------------------------------------------------------------------

# launches per dp train step at batch 2, data 2: phase 9's per-volume
# counts twice
DP_LAUNCHES = dict(conv3x3x3_fwd=26, max_pool_buf_fwd=6, conv3x3x3_dx=32,
                   conv3x3x3_wgrad=32, max_pool_buf_bwd=6)
# the dp step against the single-device step should be bit-equal (each row
# runs the same per-volume operations in the same order); if it is not,
# these bars hold and the differing parameter is printed
DP_LOSS_RTOL, DP_PARAM_ATOL = 1e-6, 1e-3
# results keys that hold wall times
TIMING_KEYS = {"duration", "voxels_per_sec_train", "voxels_per_sec_val"}


def hold_dp(single_out, dp_out, m_single, m_dp, what):
    """The dp step's (loss, counts) and parameters against the single-device
    step's: bit-equal, or the fallback bars with the first differing
    parameter named. Returns whether they were bit-equal."""
    (l1, c1), (l2, c2) = single_out, dp_out
    check(torch.equal(c1, c2), f"{what}: confusion counts differ")
    same = torch.equal(l1, l2)
    diffs = []
    for (n, p), q in zip(m_single.named_parameters(), m_dp.parameters()):
        if not torch.equal(p, q):
            d = (p - q).abs().max().item() / max(p.abs().max().item(), 1e-30)
            diffs.append((n, d))
    if same and not diffs:
        print(f"  {what}: bit-equal to the single-device step (loss "
              f"{l1.item():.6f}, counts, every parameter)", flush=True)
        return True
    rel = abs(l1.item() - l2.item()) / abs(l1.item())
    print(f"  {what}: NOT bit-equal: loss {l2.item():.8f} vs {l1.item():.8f} "
          f"(rel {rel:.2e}); {len(diffs)} parameters differ, first "
          f"{diffs[:1]}, worst max|dp| / max|p| "
          f"{max((d for _, d in diffs), default=0.0):.2e}", flush=True)
    check(rel <= DP_LOSS_RTOL, f"{what}: loss rel {rel} > {DP_LOSS_RTOL}")
    check(all(d <= DP_PARAM_ATOL for _, d in diffs),
          f"{what}: a parameter moved by more than {DP_PARAM_ATOL} max|p|")
    return False


def timed_steps(step, state, args, steps=STEPS):
    """3 warm-up and ``steps`` timed steps, losses on the device and one
    fetch: (ms/step, peak GB, loss curve)."""
    losses = [step(state, *args)[0] for _ in range(WARMUP)]
    losses[-1].item()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    for _ in range(steps):
        losses.append(step(state, *args)[0])
    curve = torch.stack(losses).cpu()
    dt = time.perf_counter() - t
    return dt / steps * 1e3, torch.cuda.max_memory_allocated() / 1e9, curve


def phase_dp_train(dev):
    """The data-parallel train and eval steps of the flagship (seed 0) at
    96^3, bf16, batch 2 (bench.py's volume and a second from numpy seed 1),
    data 2 with both rows on this card (``make_mesh(data=2,
    devices=[cuda] * 2)``, ``shard_batch``), against the single-device
    step at batch 2 from the same state, two steps (the second with
    momentum); launches per step (counts zeroed just before) twice phase
    9's per-volume counts; no plain version on a CUDA tensor; 3 warm-up
    and 20 timed steps of each, their ms/step and peak memory (the
    one-process design's overhead, not a scaling figure); a falling loss;
    a profile of one dp step; the dp eval step against the single-device
    eval step."""
    from unetsulc_tpu_torch import kernels
    from unetsulc_tpu_torch.models.unet3d import UNet3D
    from unetsulc_tpu_torch.parallel import make_mesh, shard_batch
    from unetsulc_tpu_torch.train.step import (TrainState, make_eval_step,
                                               make_eval_step_dp,
                                               make_train_step,
                                               make_train_step_dp)

    (x0, l0), (x1, l1) = make_batch(dev, 0), make_batch(dev, 1)
    x, labels = torch.cat([x0, x1]), torch.cat([l0, l1])
    del x0, l0, x1, l1
    mesh = make_mesh(data=2, devices=[dev] * 2)
    print(f"  data 2: mesh devices {[str(d) for d in mesh.devices]}: the rows "
          "run one after another on this one card, so the step time is not "
          "a scaling figure", flush=True)
    xs, ls = shard_batch(mesh, x, labels)
    m1, m2 = (UNet3D(in_channels=1, out_channels=CLASSES,
                     init_channel_number=64, device=dev, seed=0)
              for _ in range(2))
    single = make_train_step(m1, CLASSES, momentum=0.9)
    dp = make_train_step_dp(m2, CLASSES, mesh, momentum=0.9)
    s1, s2 = (TrainState.create(m, lr=TRAIN_LR) for m in (m1, m2))
    bad, equal = [], []
    for i in range(2):
        a = single(s1, x, labels)
        kernels.reset_launch_counts()
        with plain_guard(bad):
            b = dp(s2, xs, ls)
        sync()
        if i == 0:
            launches = dict(kernels.launch_counts)
        equal.append(hold_dp(a, b, m1, m2, f"dp train step {i + 1}"))
    print(f"  launches per dp train step: {launches}", flush=True)
    want = {k: 0 for k in launches}
    want.update(DP_LAUNCHES)
    check(launches == want, f"dp launches per step {launches}, expected "
          f"{want}")
    check(not bad, f"dp step: plain versions got CUDA tensors: "
          f"{sorted(set(bad))}")

    ev1, ev2 = make_eval_step(m1, CLASSES), make_eval_step_dp(m2, CLASSES, mesh)
    e1 = ev1(x, labels)
    kernels.reset_launch_counts()
    with plain_guard(bad):
        e2 = ev2(xs, ls)
    sync()
    ev_launches = {k: v for k, v in kernels.launch_counts.items() if v}
    print(f"  launches per dp eval step: {ev_launches}", flush=True)
    check(ev_launches == dict(conv3x3x3_fwd=26, max_pool_buf_fwd=6),
          f"dp eval launches {ev_launches}")
    check(torch.equal(e1[1], e2[1]), "dp eval: confusion counts differ")
    eval_equal = torch.equal(e1[0], e2[0])
    rel = abs(e1[0].item() - e2[0].item()) / abs(e1[0].item())
    print(f"  dp eval step: loss {e2[0].item():.6f} vs single-device "
          f"{e1[0].item():.6f} ({'bit-equal' if eval_equal else f'rel {rel:.2e}'}"
          "), counts equal", flush=True)
    check(rel <= DP_LOSS_RTOL, f"dp eval loss rel {rel}")
    check(not bad, "dp eval: plain versions got CUDA tensors")

    single_ms, single_gb, _ = timed_steps(single, s1, (x, labels))
    with plain_guard(bad):
        dp_ms, dp_gb, curve = timed_steps(dp, s2, (xs, ls))
    check(not bad, "dp timed steps: plain versions got CUDA tensors")
    print(f"dp train step 96^3 flagship bf16, batch 2, data 2 on one card: "
          f"{dp_ms:.2f} ms/step, peak device memory {dp_gb:.2f} GB, against "
          f"the single-device step at batch 2 {single_ms:.2f} ms/step, "
          f"{single_gb:.2f} GB ({STEPS} steps after {WARMUP} warm-up each)",
          flush=True)
    print("  loss by step: " + ", ".join(f"{v:.4f}" for v in curve.tolist()),
          flush=True)
    check(bool(torch.isfinite(curve).all()), "dp: non-finite loss")
    check(curve[-1].item() < curve[0].item(), "dp: loss did not fall")
    profile_step(lambda: dp(s2, xs, ls), "one dp step (batch 2)", 8)
    return dict(launches=launches, bit_equal=all(equal),
                eval_bit_equal=eval_equal, step_ms=dp_ms, peak_gb=dp_gb,
                single_ms=single_ms, single_gb=single_gb)


def phase_fold_parallel(seq, dev):
    """Phase 21's training CV again with ``tpu.fold_parallel: 2`` through
    ``run_experiment(..., devices=[dev] * 2)``: two fold threads, both
    groups on this card; every non-timing results key equal to phase 21's
    sequential run, the group layout recorded, the launches in all equal to
    the sequential run's, no plain version on a CUDA tensor."""
    from unetsulc_tpu_torch import kernels
    from unetsulc_tpu_torch.config import Parameters
    from unetsulc_tpu_torch.experiment.driver import run_experiment

    src = seq["params"]["working_path"]
    root = os.path.join(WORK, "experiment_folds")
    shutil.rmtree(root, ignore_errors=True)
    # the same graph files: the cohort file names them by path
    shutil.copytree(os.path.join(src, "cohorts"), os.path.join(root, "cohorts"))
    params = {**seq["params"], "working_path": root,
              "tpu": {"fold_parallel": 2}}
    bad = []
    kernels.reset_launch_counts()
    t = time.time()
    with plain_guard(bad):
        results = run_experiment(Parameters.from_dict(params),
                                 devices=[dev] * 2)
    sync()
    wall = time.time() - t
    launched = {k: kernels.launch_counts[k] for k in FUSED_KERNELS}
    check(not bad, f"fold_parallel: plain versions got CUDA tensors: "
          f"{sorted(set(bad))}")
    layout = results.pop("fold_parallel", None)
    print(f"  fold_parallel layout: {layout}", flush=True)
    check(layout == {"n_groups": 2, "groups": [[str(dev)], [str(dev)]],
                     "folds": {"0": 0, "1": 1, "2": 0}},
          f"fold_parallel layout {layout}")
    ref = seq["results"]
    check(set(ref) - TIMING_KEYS == set(results) - TIMING_KEYS,
          f"fold_parallel results keys {sorted(results)}")
    differ = sorted(k for k in set(ref) - TIMING_KEYS if ref[k] != results[k])
    check(not differ, f"fold_parallel results differ from the sequential "
          f"run on {differ}")
    check(launched == seq["main_launches"], f"fold_parallel launches "
          f"{launched}, sequential {seq['main_launches']}")
    print(f"fold_parallel 2 on one card: results equal to the sequential "
          f"run on every non-timing key; launches {launched}; main() "
          f"{wall:.1f} s against {seq['wall_s']:.1f} s sequential", flush=True)
    return dict(wall_s=wall, seq_wall_s=seq["wall_s"])


def phase_train_parts(seq):
    """Phase 21's CV train phase in parts: fold 0 of the same cohort and
    configuration, two epochs through ``learning()``, each train phase's
    ``_epoch_pass`` given ``spans`` (host seconds of each part,
    utils/profiling.py HostSpans): in the prefetch thread making the
    batches (``batch``; within it the dataset's own parts: the cached
    points as arrays, translation and augmentation, label ids,
    voxelization; the rest is the bucket copy), pinning and enqueueing the
    upload; in the main thread waiting for a batch, dispatching the
    steps, the end-of-phase fetch. Epoch 0 runs as phase 21 does; epoch 1
    under the profiler, for the device's busy share and the upload's
    device time. Then the voxelizer alone, native against numpy on the
    same four volumes (bit-equal), ms per volume."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from unetsulc_tpu_torch.config import Parameters
    from unetsulc_tpu_torch.data import dataset as dataset_mod
    from unetsulc_tpu_torch.data.dataset import SulciDataset
    from unetsulc_tpu_torch.data.voxelize import voxelize
    from unetsulc_tpu_torch.experiment.driver import (build_method,
                                                      kfold_splits,
                                                      load_cohort)
    from unetsulc_tpu_torch.method.training import TrainingSulciLabeller
    from unetsulc_tpu_torch.utils.profiling import HostSpans

    params = Parameters.from_dict(seq["params"])
    graphs, _ = load_cohort(params)
    method = build_method(params, graphs)
    train, test = next(kfold_splits(len(graphs), params.n_cvinner))
    agraphs = np.asarray(graphs)
    parts = []
    orig = TrainingSulciLabeller._epoch_pass

    def timed(self, phase, state, step_fn, dataset, img_size, batch_size,
              epoch, *a, **kw):
        if phase != "train":
            return orig(self, phase, state, step_fn, dataset, img_size,
                        batch_size, epoch, *a, **kw)
        spans = HostSpans()
        sync()
        prof = (profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])
                if epoch == 1 else contextlib.nullcontext())
        with prof as p:
            t = time.perf_counter()
            out = orig(self, phase, state, step_fn, dataset, img_size,
                       batch_size, epoch, *a, spans=spans, **kw)
            sync()
            wall = time.perf_counter() - t
        rec = dict(epoch=epoch, wall_ms=wall * 1e3, volumes=len(dataset),
                   ms={k: v * 1e3 for k, v in spans.seconds.items()},
                   calls=dict(spans.calls))
        if p is not None:
            dev_ms = [(e.key, e.self_device_time_total / 1e3)
                      for e in p.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0]
            rec["busy_ms"] = sum(ms for _, ms in dev_ms)
            rec["htod_ms"] = sum(ms for k, ms in dev_ms if "HtoD" in k)
        parts.append(rec)
        return out

    TrainingSulciLabeller._epoch_pass = timed
    try:
        method.learning(lr=params.lr, momentum=params.momentum, num_epochs=2,
                        gfile_list_train=agraphs[train],
                        gfile_list_test=agraphs[test], batch_size=1,
                        save_results=False)
    finally:
        TrainingSulciLabeller._epoch_pass = orig
    check([r["epoch"] for r in parts] == [0, 1], f"train phases {parts}")
    for r in parts:
        ms, n = r["ms"], r["volumes"]
        main = sum(ms.get(k, 0.0) for k in ("wait", "step", "fetch"))
        item = {k: ms.get(k, 0.0) / n
                for k in ("points", "augment", "ids", "voxelize")}
        line = (f"  train phase in parts, epoch {r['epoch']}"
                f"{' (under the profiler)' if 'busy_ms' in r else ''}: "
                f"{r['wall_ms']:.1f} ms for {n} volumes "
                f"({r['wall_ms'] / n:.1f} ms per volume); prefetch thread: "
                f"batch making {ms.get('batch', 0):.1f} ms "
                f"({ms.get('batch', 0) / n:.1f} per volume: load points "
                f"{item['points']:.2f} (the cached lists to arrays), "
                f"translate and augment {item['augment']:.2f}, label ids "
                f"{item['ids']:.2f}, voxelize (native) {item['voxelize']:.2f}, "
                f"bucket copy and the rest "
                f"{ms.get('batch', 0) / n - sum(item.values()):.2f}), pin "
                f"{ms.get('pin', 0):.1f}, upload {ms.get('upload', 0):.1f}; "
                f"main thread: wait {ms.get('wait', 0):.1f}, steps "
                f"{ms.get('step', 0):.1f} (dispatch; {ms.get('step', 0) / n:.1f} "
                f"per volume), fetch {ms.get('fetch', 0):.1f}, other "
                f"{r['wall_ms'] - main:.1f}")
        if "busy_ms" in r:
            line += (f"; device busy {r['busy_ms']:.1f} ms = "
                     f"{r['busy_ms'] / r['wall_ms'] * 100:.1f}% (idle "
                     f"{100 - r['busy_ms'] / r['wall_ms'] * 100:.1f}%), "
                     f"upload copies {r['htod_ms']:.2f} ms on the device")
        print(line, flush=True)
        check(all(v >= 0 for v in ms.values()), "negative span")
        check(r["calls"].get("step") == n
              and all(r["calls"].get(k) == n for k in item),
              f"steps and items timed {r['calls']}")

    # the voxelizer alone on the same volumes: native against numpy
    ds = SulciDataset(agraphs[train], method.dict_sulci,
                      train=method.tpu.augment, translation_file=method.trfile,
                      dict_bck2=method.dict_bck2, dict_names=method.dict_names,
                      seed=42)
    captured = []
    orig_vox = dataset_mod.voxelize

    def capture(bck2, ids, img_size=None):
        captured.append((bck2, ids, img_size))
        return orig_vox(bck2, ids, img_size=img_size)

    dataset_mod.voxelize = capture
    try:
        for i in range(len(ds)):
            ds[i]
    finally:
        dataset_mod.voxelize = orig_vox
    per = {True: [], False: []}
    for bck2, ids, size in captured:
        outs = {}
        for native in (True, False):
            ts = []
            for _ in range(5):
                t = time.perf_counter()
                outs[native] = voxelize(bck2, ids, img_size=size,
                                        use_native=native)
                ts.append(time.perf_counter() - t)
            per[native].append(statistics.median(ts) * 1e3)
        check(all(np.array_equal(u, v) for u, v in zip(outs[True],
                                                        outs[False])),
              "native voxelizer differs from numpy")
    shapes = [tuple(int(v) for v in np.max(c[0], axis=0) + 1)
              for c in captured]
    nat, npy = statistics.mean(per[True]), statistics.mean(per[False])
    print(f"  voxelizer on the same {len(captured)} volumes ({len(captured[0][0])}"
          f"-{max(len(c[0]) for c in captured)} points, extents {shapes}): "
          f"native {nat:.2f} ms per volume, numpy {npy:.2f} ms per volume "
          f"(medians of 5), bit-equal", flush=True)
    return dict(parts=parts, native_ms=nat, numpy_ms=npy)


# ---------------------------------------------------------------------------
# the spatially sharded non-fused step (phase 23)
# ---------------------------------------------------------------------------

HALO_SPACES = (2, 3)
# shard slabs of the flagship's levels at space 2 (rows of the longer
# shard, Y = Z extent, the level's widest GroupNorm)
GN_SHARD_SLABS = [(48, 96, 64), (25, 49, 128), (13, 25, 256), (7, 13, 512)]
# group_norm_sharded against the single-device kernels: (extent, C, rows
# of each shard)
GN_SHARDED_CASES = [(96, 64, [48, 48]), (49, 128, [16, 16, 17])]
HALO_STEPS = 10
HALO_COVER = ("one 96^3 non-fused flagship sharded training step, space 2, "
              "one card")


def halo_gn_launches(n):
    """GroupNorm launches per sharded non-fused train step of the flagship
    at 96^3 over ``n`` shards, from the partition: per GroupNorm layer one
    sums launch, one gn_apply, one gn_bwd_reduce and one gn_bwd_dx_denom
    on each shard holding rows of its level (parallel.halo.level_rows),
    one gn_finalize on the home shard; no gn_stats, no gn_bwd_dx."""
    from unetsulc_tpu_torch.parallel.halo import level_rows

    live = sum(sum(hi > lo for lo, hi in level_rows(ext, n))
               for _, ext, _ in GN_LAYERS)
    return dict(gn_stats_sums=live, gn_finalize=len(GN_LAYERS),
                gn_apply=live, gn_bwd_reduce=live, gn_bwd_dx_denom=live)


def gn_close(got, want, what):
    """f32 against f32: rtol 1e-5, atol 1e-5 of the largest |want| (f32
    sums over the shards in another order). Returns the max |error|."""
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale,
                               msg=lambda m: f"{what}: {m}")
    return (got - want).abs().max().item()


def phase_gn_shard_checks(dev):
    """The sharded GroupNorm's kernel modes against their plain versions
    at the flagship's space-2 shard slabs (bf16 and f32): gn_stats_sums'
    sums rtol 1e-4 (phase 12's bar for the statistics), gn_finalize's mean
    and inv from the plain sums rtol 1e-4, gn_bwd_dx with the whole
    level's count as kernel C; then ``group_norm_sharded`` (f32, 96^3 x
    64 in 48 + 48 rows, 49^3 x 128 in 16 + 16 + 17) forward and backward
    against the single-device GroupNorm kernels at rtol 1e-5."""
    from unetsulc_tpu_torch.ops import groupnorm as gn

    gen = torch.Generator(device=dev).manual_seed(23)
    worst = {k: 0.0 for k in GN_SHARD_KERNELS}
    for rows, yz, c in GN_SHARD_SLABS:
        for dtype in (torch.bfloat16, torch.float32):
            what = f"{rows}x{yz}x{yz} x {c} {str(dtype)[6:]}"
            x, g, scale, _ = gn_inputs(1, rows * yz * yz, c, dtype, gen, dev)
            sk, sp = gn.gn_sums(x, 32), gn.gn_sums_plain(x, 32)
            sync()
            for k, p, name in zip(sk, sp, ("sum", "sum of squares")):
                torch.testing.assert_close(
                    k, p, rtol=1e-4, atol=0,
                    msg=lambda m: f"gn_stats_sums {name} ({what}): {m}")
            err = {"gn_stats_sums": max((k - p).abs().max().item()
                                        for k, p in zip(sk, sp))}
            count = 2 * rows * yz * yz * (c // 32)  # a whole level's
            mk = gn.gn_finalize(*sp, count, 1e-5)
            mp = gn.gn_finalize_plain(*sp, count, 1e-5)
            sync()
            for k, p in zip(mk, mp):
                torch.testing.assert_close(
                    k, p, rtol=1e-4, atol=0,
                    msg=lambda m: f"gn_finalize ({what}): {m}")
            err["gn_finalize"] = max((k - p).abs().max().item()
                                     for k, p in zip(mk, mp))
            red = gn.gn_bwd_reduce_plain(x, g, *mp, scale)
            dk = gn.gn_bwd_dx(x, g, *mp, scale, red[2], red[3], denom=count)
            dp = gn.gn_bwd_dx_plain(x, g, *mp, scale, red[2], red[3],
                                    denom=count)
            sync()
            check(dk.dtype == x.dtype, f"gn_bwd_dx_denom dtype ({what})")
            err["gn_bwd_dx_denom"] = check_grad(dk, dp, 2 ** -7,
                                                f"gn_bwd_dx_denom ({what})")
            for k, v in err.items():
                worst[k] = max(worst[k], v)
            print(f"  sharded GN modes {what}: "
                  + ", ".join(f"{k} {v:.3g}" for k, v in err.items()),
                  flush=True)
    for ext, c, sizes in GN_SHARDED_CASES:
        x, g, scale, bias = (t.float() for t in gn_inputs(
            1, ext ** 3, c, torch.float32, gen, dev))
        x5, g5 = x.view(1, ext, ext, ext, c), g.view(1, ext, ext, ext, c)
        sc, bi = scale.clone().requires_grad_(True), bias.clone()
        bi.requires_grad_(True)
        xa = x5.clone().requires_grad_(True)
        want = gn.group_norm(xa, 32, sc, bi)
        want.backward(g5)
        ref = [t.grad.clone() for t in (xa, sc, bi)]
        sc.grad = bi.grad = None
        xs = [t.clone().requires_grad_(True)
              for t in torch.split(x5, sizes, dim=1)]
        outs = gn.group_norm_sharded(xs, 32, sc, bi)
        torch.autograd.backward(outs, list(torch.split(g5, sizes, dim=1)))
        sync()
        what = f"group_norm_sharded {ext}^3 x {c} in {sizes}"
        errs = [gn_close(torch.cat(outs, 1).detach(), want.detach(),
                         f"{what} forward"),
                gn_close(torch.cat([t.grad for t in xs], 1), ref[0],
                         f"{what} dx"),
                gn_close(sc.grad, ref[1], f"{what} dscale"),
                gn_close(bi.grad, ref[2], f"{what} dbias")]
        print(f"  {what} against the single-device kernels (f32): forward "
              f"{errs[0]:.3g}, dx {errs[1]:.3g}, dscale {errs[2]:.3g}, "
              f"dbias {errs[3]:.3g}", flush=True)
    return worst


def hold_steps(ref, got, where):
    """A sharded step's (loss, counts, gradients) against the
    single-device step's at phase 9's bars; returns the distances."""
    (l1, c1, g1), (l2, c2, g2) = ref, got
    d = param_distances(g2, g1)
    gcos = global_cosine(g2, g1)
    c, cn, e, en = worst(d)
    print(f"  {where}: loss {l2:.6f} vs single-device {l1:.6f} (rel "
          f"{abs(l2 - l1) / abs(l1):.2e}); confusion counts equal: "
          f"{bool(torch.equal(c1, c2))}; all-parameter cosine {gcos:.6f}; "
          f"worst cosine {1.0 - c:.6f} ({cn}); worst max|dg| / max|g| "
          f"{e:.4f} ({en})", flush=True)
    check(abs(l2 - l1) <= LOSS_RTOL * abs(l1), f"{where}: loss differs")
    check(gcos >= GLOBAL_COS, f"{where}: all-parameter cosine {gcos}")
    check(1.0 - c >= GRAD_COS, f"{where}: gradient cosine {1.0 - c}")
    check(e <= GRAD_ERR, f"{where}: gradient error {e}")
    return dict(loss_rel=abs(l2 - l1) / abs(l1), global_cos=gcos,
                cos=1.0 - c, err=e)


def phase_halo_train(dev):
    """The sharded non-fused step (``make_train_step_sp_halo``, every
    shard on this card) of phase 14's model on phase 9's batch at space 2
    and 3 (levels 96, 49, 25, 13 split 48/48, 24/25, 12/13, 6/7 and
    32/32/32, 16/16/17, 8/8/9, 4/4/5 rows), against the single-device
    non-fused step from the same state at phase 9's bars; GroupNorm
    launches per step (counts zeroed just before) against the partition's;
    no plain version on a CUDA tensor; 3 warm-up and 10 timed steps of
    each beside the single-device step's, peak memory; a falling loss; a
    profile of one sharded step; the sharded eval step; then one f32 step at space 2 of the 'crg'
    interpolating flagship (f32 on the card: the non-fused path) against
    its single-device step, and ``graft_entry.dryrun_multichip(2)``.
    Returns the runs and every GroupNorm launch of one space-2 step
    (recorded, lr 0)."""
    from unetsulc_tpu_torch import kernels
    from unetsulc_tpu_torch.graft_entry import dryrun_multichip
    from unetsulc_tpu_torch.models.unet3d import UNet3D
    from unetsulc_tpu_torch.parallel import shard_x
    from unetsulc_tpu_torch.train.step import (TrainState, make_train_step,
                                               make_eval_step_sp_halo,
                                               make_train_step_sp_halo)

    x, labels = make_batch(dev)
    model = nonfused_model(dev)
    single = make_train_step(model, CLASSES, momentum=0.9)
    ref = step_grads(model, single, (x, labels))
    runs, bad, calls = {}, [], []
    for n in HALO_SPACES:
        mesh = sp_mesh(n)
        xs, ls = shard_x(x, mesh), shard_x(labels, mesh)
        step = make_train_step_sp_halo(model, CLASSES, mesh, momentum=0.9)
        got = step_grads(model, step, (xs, ls))
        held = hold_steps(ref, got, f"space {n}, bf16 interpolate=False")
        kernels.reset_launch_counts()
        with plain_guard(bad):
            step(TrainState.create(model, lr=0.0), xs, ls)
        sync()
        launches = {k: v for k, v in kernels.launch_counts.items() if v}
        want = halo_gn_launches(n)
        print(f"  space {n}: launches per sharded non-fused train step: "
              f"{launches} (the partition's: {want})", flush=True)
        check(launches == want, f"space {n}: launches {launches}, expected "
              f"{want}")
        check(not bad, f"space {n}: plain versions got CUDA tensors: "
              f"{sorted(set(bad))}")
        el, ec = make_eval_step_sp_halo(model, CLASSES, mesh)(xs, ls)
        sync()
        n_valid = int((labels != -1).sum().item())
        check(bool(torch.isfinite(el)), f"space {n}: non-finite eval loss")
        check(int(ec[0].sum() + ec[2].sum()) == n_valid,
              f"space {n}: eval counts do not cover the labelled voxels")
        runs[n] = dict(launches=launches, eval_loss=el.item(), **held,
                       args=(xs, ls))
        del step
    # timing: the single-device step and each space in one call, from the
    # same initial state (a fresh model each)
    single_ms, single_gb, _ = timed_steps(
        single, TrainState.create(model, lr=TRAIN_LR), (x, labels),
        HALO_STEPS)
    del model, single
    for n in HALO_SPACES:
        m = nonfused_model(dev)
        mesh = sp_mesh(n)
        step = make_train_step_sp_halo(m, CLASSES, mesh, momentum=0.9)
        state, args = TrainState.create(m, lr=TRAIN_LR), runs[n].pop("args")
        with plain_guard(bad):
            ms, gb, curve = timed_steps(step, state, args, HALO_STEPS)
        check(not bad, f"space {n}: plain versions got CUDA tensors")
        check(bool(torch.isfinite(curve).all()), f"space {n}: non-finite loss")
        check(curve[-1].item() < curve[0].item(),
              f"space {n}: loss did not fall")
        print(f"sharded non-fused train step 96^3 flagship bf16 "
              f"(interpolate=False), space {n} on one card: {ms:.2f} ms/step, "
              f"peak device memory {gb:.2f} GB, against the single-device "
              f"non-fused step {single_ms:.2f} ms/step, {single_gb:.2f} GB "
              f"({HALO_STEPS} steps after {WARMUP} warm-up each)", flush=True)
        print("  loss by step: " + ", ".join(f"{v:.4f}" for v in
                                             curve.tolist()), flush=True)
        runs[n].update(step_ms=ms, peak_gb=gb, single_ms=single_ms,
                       single_gb=single_gb)
        profile_step(lambda: step(state, *args),
                     f"one space-{n} sharded non-fused step", 10)
        del m, step, state, args
    # f32 on the card: the 'crg' interpolating flagship takes this route
    m32 = UNet3D(in_channels=1, out_channels=CLASSES, init_channel_number=64,
                 compute_dtype=torch.float32, device=dev, seed=0)
    check(not m32.fused_config(), "an f32 model on the card is not fused")
    mesh = sp_mesh(2)
    ref32 = step_grads(m32, make_train_step(m32, CLASSES, momentum=0.9),
                       (x, labels))
    got32 = step_grads(m32, make_train_step_sp_halo(m32, CLASSES, mesh,
                                                    momentum=0.9),
                       (shard_x(x, mesh), shard_x(labels, mesh)))
    runs["f32"] = hold_steps(ref32, got32,
                             "space 2, f32 'crg' interpolating flagship")
    del m32, ref32, got32
    t = time.perf_counter()
    dryrun_multichip(2)
    sync()
    runs["dryrun_s"] = time.perf_counter() - t
    # last, as its recorded operands stay allocated: every GroupNorm
    # launch of one space-2 step
    model, mesh = nonfused_model(dev), sp_mesh(HALO_SPACES[0])
    with recording(calls, ["gn_stats_sums", "gn_finalize", "gn_bwd_dx"]):
        make_train_step_sp_halo(model, CLASSES, mesh)(
            TrainState.create(model, lr=0.0), shard_x(x, mesh),
            shard_x(labels, mesh))
    sync()
    return runs, calls


def gn_shard_rows(calls):
    """Every recorded launch of the sharded GroupNorm's modes in one
    space-2 step, held to its plain version (phase 23's bars) and timed
    against its bound; no PyTorch call computes a shard's sums, the
    finalize or dx with another shard's sums, so no library time."""
    plain_of = plain_fns()
    rows = {k: [] for k in GN_SHARD_KERNELS}
    with torch.no_grad():
        for name, args, kw in calls:
            if name == "gn_bwd_dx":
                check(kw.get("denom") is not None,
                      "the sharded step launched gn_bwd_dx without denom")
                name = "gn_bwd_dx_denom"
            fn = dispatcher("gn_bwd_dx" if name == "gn_bwd_dx_denom"
                            else name)
            plain = plain_of["gn_bwd_dx" if name == "gn_bwd_dx_denom"
                             else name]
            kern = lambda: fn(*args, **kw)  # noqa: E731
            ref = lambda: plain(*args, **kw)  # noqa: E731
            out_k, out_p = kern(), ref()
            sync()
            if name == "gn_bwd_dx_denom":
                x3 = args[0]
                err = check_grad(out_k, out_p, 2 ** -7, f"{name}")
                bound = gn_bound("gn_bwd_dx", x3, int(args[2].shape[1]))
                shape = f"{int(x3.shape[2])} @{int(x3.shape[1])} voxels"
            else:
                for k, p in zip(out_k, out_p):
                    torch.testing.assert_close(
                        k, p, rtol=1e-4, atol=0,
                        msg=lambda m: f"{name}: {m}")
                err = max((k - p).abs().max().item()
                          for k, p in zip(out_k, out_p))
                if name == "gn_stats_sums":
                    x3 = args[0]
                    bound = gn_bound("gn_stats", x3, int(args[1]))
                    shape = f"{int(x3.shape[2])} @{int(x3.shape[1])} voxels"
                else:
                    # reads sums and squares, writes mean and inv: (N, G)
                    # f32 each; ~6 operations per unit
                    units = args[0].numel()
                    bound = max(16.0 * units / PEAK_BYTES,
                                6.0 * units / PEAK_F32_FLOPS) * 1e3
                    shape = f"{units} units"
            rows[name].append(timed_row(name, shape, kern, ref, None, bound,
                                        err))
    for name, rs in rows.items():
        ms = sum(r["ms"] for r in rs)
        bound = sum(r["bound_ms"] for r in rs)
        print(f"  {name}: {len(rs)} launches per space-2 step, {ms:.4f} ms, "
              f"{bound / ms * 100:.1f}% of its bound ({bound:.4f} ms)",
              flush=True)
    return rows


# ---------------------------------------------------------------------------
# the pattern classifier and remat (phase 24)
# ---------------------------------------------------------------------------

# the pattern classifier at full width: PatternCNN3D (16, 32, 64) in f32
# (the trainer's default) on a 96^3 box (the flagship's bucket, a whole
# hemisphere), batch 4 (the trainer's default), on synthetic graphs of
# extent 90, every other one with a dense blob (the pattern);
# tests/test_pattern_cnn.py's learning settings (30 epochs, lr 3e-3)
PATTERN_BOX = 96
PATTERN_EXTENT = 90
PATTERN_GRAPHS = 12
PATTERN_BATCH = 4
PATTERN_EPOCHS, PATTERN_LR = 30, 3e-3
PATTERN_STEPS = 10
# the pattern step against its plain step: phase 23's f32 loss bar
PATTERN_LOSS_RTOL = 1e-5
# its GroupNorm layers: (stage, norm, extent, channels); groups of one
# channel but in the last (32 groups of 2)
PATTERN_GN = [(0, 1, 96, 8), (0, 2, 96, 16), (1, 1, 49, 16), (1, 2, 49, 32),
              (2, 1, 25, 32), (2, 2, 25, 64)]
# forward kernels: a remat step replays each block's forward once more
FORWARD_KERNELS = ["conv3x3x3_fwd", "conv3x3x3_fwd_halo", "max_pool_buf_fwd",
                   "gn_stats", "gn_apply"]
REMAT_STEPS = 10


def make_pattern_graphs(root, n):
    """``n`` synthetic graphs of extent PATTERN_EXTENT (two labels, two
    random-walk folds of 600 steps each), saved as ``L_pattern<i>.npz``;
    every other one also holds a 'S.C._left' fold of 2000 points drawn
    uniformly in a 24^3 corner cube, ~14% of its voxels
    (tests/test_pattern_cnn.py's blob, 80 points in 8^3, at this extent).
    Returns (files, labels)."""
    from unetsulc_tpu_torch.io.container import save_graph_npz
    from unetsulc_tpu_torch.io.graph import Vertex, make_synthetic_graph

    os.makedirs(root, exist_ok=True)
    files, labels = [], []
    for i in range(n):
        rng = np.random.default_rng(400 + i)
        g = make_synthetic_graph(rng, ["F.C.M._left", "S.T.s._left"],
                                 n_folds_per_label=2, points_per_fold=600,
                                 extent=PATTERN_EXTENT)
        if i % 2 == 0:
            blob = rng.integers(6, 30, size=(2000, 3)).astype(np.int32)
            g.add_vertex(Vertex(index=99, name="S.C._left",
                                buckets={"aims_ss": blob}))
        path = os.path.join(root, f"L_pattern{i}.npz")
        save_graph_npz(g, path)
        files.append(path)
        labels.append(int(i % 2 == 0))
    return files, labels


def snapshot(model, opt):
    """The model's parameters and the optimizer's state."""
    import copy

    return ({n: p.detach().clone() for n, p in model.named_parameters()},
            copy.deepcopy(opt.state_dict()))


def restore(model, opt, snap):
    import copy

    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(snap[0][n])
    opt.load_state_dict(copy.deepcopy(snap[1]))


def pattern_step_from(model, opt, step, snap, x, y, plain=False):
    """One Adam step from ``snap`` (through the plain versions on the card
    with ``plain``): (loss, gradients, parameters after)."""
    restore(model, opt, snap)
    with plain_ops() if plain else contextlib.nullcontext():
        loss = step(x, y)
    sync()
    return (loss.item(),
            {n: p.grad.detach().clone() for n, p in model.named_parameters()},
            {n: p.detach().clone() for n, p in model.named_parameters()})


def pattern_gn_rows(calls):
    """Every GroupNorm launch of one pattern step, launched twice
    (bit-equal), held to its plain version at phase 12's bars and timed as
    phase 15 times the non-fused step's (against ``F.group_norm`` /
    ``native_group_norm_backward`` and the bound)."""
    plain_of = plain_fns()
    rows = {n: [] for n in GN_KERNELS}
    with torch.no_grad():
        for name, args, kw in calls:
            x3, groups, _, _ = gn_operands(name, args)
            kern = lambda: dispatcher(name)(*args, **kw)  # noqa: E731
            plain = lambda: plain_of[name](*args)  # noqa: E731
            shape = (f"{int(x3.shape[2])} @{int(x3.shape[1])} voxels x "
                     f"{int(x3.shape[0])}, G {groups}, {str(x3.dtype)[6:]}")
            out = kern()
            check(bit_equal(out, kern()),
                  f"{name} ({shape}) differs between two runs")
            err = gn_check_call(name, out, plain(), shape)
            sync()
            rows[name].append(timed_row(
                name, shape, kern, plain, gn_library_call(name, args),
                gn_bound(name, x3, groups), err))
    for name, rs in rows.items():
        ms = sum(r["ms"] for r in rs)
        bound = sum(r["bound_ms"] for r in rs)
        lib = sum(r["library_ms"] for r in rs)
        print(f"  {name}: {len(rs)} launches per pattern step, {ms:.4f} ms "
              f"({bound / ms * 100:.1f}% of its bound, {bound:.4f} ms), "
              f"library {lib:.4f} ms", flush=True)
    return rows


def phase_pattern(dev):
    """The pattern classifier at full width (PATTERN_* above): one Adam
    step's GroupNorm launches per layer (counts zeroed just before), each
    recorded launch held to its plain version at phase 12's bars and
    timed; from the state after 3 warm-up steps (the head starts at zero,
    which hides the trunk from the first gradient) the kernel step twice
    (bit-equal loss, gradients and updated parameters) and against the
    plain step (loss rtol PATTERN_LOSS_RTOL, gradients at phase 9's bars);
    3 warm-up and PATTERN_STEPS timed steps, peak memory, a profile; then
    ``train_pattern_classifier`` on the graphs (tests/test_pattern_cnn.py's
    settings, its GroupNorm launches against the epochs'): a falling loss
    and a best eval accuracy >= 0.9 (eval: the same graphs without
    augmentation, a memorization check). Returns the numbers and the GN
    rows."""
    from unetsulc_tpu_torch import kernels
    from unetsulc_tpu_torch.data.dataset import PatternDataset
    from unetsulc_tpu_torch.models.pattern_cnn import (
        PatternCNN3D, make_pattern_train_step, train_pattern_classifier)

    files, labels = make_pattern_graphs(os.path.join(WORK, "pattern"),
                                        PATTERN_GRAPHS)
    bb = [[0, PATTERN_BOX - 1]] * 3
    train_ds = PatternDataset(files, pattern="S.C.", bb=bb, train=True)
    eval_ds = PatternDataset(files, pattern="S.C.", bb=bb, train=False)
    items = [train_ds[i] for i in range(PATTERN_BATCH)]
    check([y for _, y in items] == labels[:PATTERN_BATCH]
          and [eval_ds[i][1] for i in range(len(files))] == labels,
          "PatternDataset labels differ from the graphs'")
    x = torch.from_numpy(np.stack([a for a, _ in items])).to(dev)
    y = torch.tensor([float(b) for _, b in items], device=dev)
    occupied = [int(a.sum()) for a, _ in items]
    print(f"  batch {tuple(x.shape)} f32, occupied voxels {occupied}, labels "
          f"{[int(v) for v in y.tolist()]}", flush=True)

    model = PatternCNN3D(compute_dtype=torch.float32, device=dev,
                         generator=torch.Generator().manual_seed(0))
    opt, step = make_pattern_train_step(model, PATTERN_LR)
    kernels.reset_launch_counts()
    step(x, y)
    sync()
    launches = {k: v for k, v in kernels.launch_counts.items() if v}
    want = {k: len(PATTERN_GN) for k in GN_KERNELS}
    print(f"  launches per pattern step: {launches} (predicted {want})",
          flush=True)
    check(launches == want, f"pattern step launches {launches}, predicted "
          f"{want}")
    for _ in range(WARMUP - 1):
        step(x, y)
    snap = snapshot(model, opt)
    lk, gk, pk = pattern_step_from(model, opt, step, snap, x, y)
    lk2, gk2, pk2 = pattern_step_from(model, opt, step, snap, x, y)
    differ = [n for n in gk if not (torch.equal(gk[n], gk2[n])
                                    and torch.equal(pk[n], pk2[n]))]
    check(lk == lk2 and not differ, "two pattern steps from one state "
          f"differ (loss equal {lk == lk2}; parameters {differ})")
    lp, gp, _ = pattern_step_from(model, opt, step, snap, x, y, plain=True)
    d = param_distances(gk, gp)
    gcos = global_cosine(gk, gp)
    c, cn, e, en = worst(d)
    print(f"  pattern step from the state after {WARMUP} steps: loss "
          f"{lk:.8f} vs plain {lp:.8f} (rel {abs(lk - lp) / abs(lp):.2e}); "
          f"two kernel steps bit-equal (loss, gradients, parameters); "
          f"all-parameter cosine {gcos:.8f}; worst cosine {1.0 - c:.8f} "
          f"({cn}); worst max|dg| / max|g| {e:.3g} ({en})", flush=True)
    check(abs(lk - lp) <= PATTERN_LOSS_RTOL * abs(lp),
          "pattern step: loss differs from the plain step")
    check(gcos >= GLOBAL_COS, f"pattern step: all-parameter cosine {gcos}")
    check(1.0 - c >= GRAD_COS, f"pattern step: gradient cosine {1.0 - c}")
    check(e <= GRAD_ERR, f"pattern step: gradient error {e}")

    calls = []
    restore(model, opt, snap)
    with recording(calls, GN_KERNELS):
        step(x, y)
    sync()
    check(len(calls) == 4 * len(PATTERN_GN),
          f"{len(calls)} GroupNorm launches recorded in a pattern step")
    rows = pattern_gn_rows(calls)
    del calls

    restore(model, opt, snap)
    losses = [step(x, y) for _ in range(WARMUP)]
    losses[-1].item()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    losses += [step(x, y) for _ in range(PATTERN_STEPS)]
    curve = torch.stack(losses).cpu()
    step_ms = (time.perf_counter() - t) / PATTERN_STEPS * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(bool(torch.isfinite(curve).all()), "pattern step: non-finite loss")
    profile_step(lambda: step(x, y), "one pattern step", 8)
    print(f"pattern step (PatternCNN3D (16, 32, 64) f32, {PATTERN_BOX}^3, "
          f"batch {PATTERN_BATCH}, Adam): {step_ms:.2f} ms/step, peak device "
          f"memory {peak_gb:.2f} GB ({PATTERN_STEPS} steps after {WARMUP} "
          "warm-up); GroupNorm kernels per step "
          + ", ".join(f"{k} {sum(r['ms'] for r in rs):.4f} ms"
                      for k, rs in rows.items()), flush=True)
    del model, opt, step, snap

    kernels.reset_launch_counts()
    t = time.perf_counter()
    trained, hist = train_pattern_classifier(
        train_ds, num_epochs=PATTERN_EPOCHS, lr=PATTERN_LR,
        batch_size=PATTERN_BATCH, generator=torch.Generator().manual_seed(0),
        eval_dataset=eval_ds, device=dev)
    sync()
    wall_s = time.perf_counter() - t
    learn = {k: v for k, v in kernels.launch_counts.items() if v}
    steps = -(-len(files) // PATTERN_BATCH)
    per_epoch_fwd = (steps + len(files)) * len(PATTERN_GN)
    want = {k: PATTERN_EPOCHS * (per_epoch_fwd if k in ("gn_stats", "gn_apply")
                                 else steps * len(PATTERN_GN))
            for k in GN_KERNELS}
    print(f"train_pattern_classifier: {len(files)} graphs, "
          f"{PATTERN_EPOCHS} epochs, lr {PATTERN_LR}, batch {PATTERN_BATCH}: "
          f"{wall_s:.1f} s wall; loss first {hist['loss'][0]:.4f}, last "
          f"{hist['loss'][-1]:.4f}; eval accuracy best "
          f"{max(hist['eval_acc']):.3f}, last {hist['eval_acc'][-1]:.3f}; "
          f"launches {learn} (predicted {want})", flush=True)
    print("  loss by epoch: " + ", ".join(f"{v:.4f}" for v in hist["loss"]),
          flush=True)
    print("  eval accuracy by epoch: "
          + ", ".join(f"{v:.3f}" for v in hist["eval_acc"]), flush=True)
    check(learn == want, f"trainer launches {learn}, predicted {want}")
    check(hist["loss"][-1] < hist["loss"][0], "the pattern loss did not fall")
    check(max(hist["eval_acc"]) >= 0.9,
          f"best eval accuracy {max(hist['eval_acc'])} < 0.9")
    del trained
    return dict(launches=launches, step_ms=step_ms, peak_gb=peak_gb,
                loss_rel=abs(lk - lp) / abs(lp), global_cos=gcos,
                cos=1.0 - c, err=e, train_s=wall_s,
                best_acc=max(hist["eval_acc"]), loss_first=hist["loss"][0],
                loss_last=hist["loss"][-1]), rows


def remat_pair(make_model, make_step, args, where):
    """One model's step with and without ``remat`` from one state (its
    seeded init): loss, confusion counts, every gradient (lr 0) and the
    parameters after one update (lr TRAIN_LR) bit-equal; forward kernels'
    launches per step twice those without remat, the others equal. On a
    difference, the parameters whose gradient or update differs are
    printed, first in the model's order (the first block that
    differs). Returns the launches of each."""
    from unetsulc_tpu_torch import kernels
    from unetsulc_tpu_torch.train.step import TrainState

    out = []
    for remat in (False, True):
        model = make_model(remat)
        step = make_step(model)
        kernels.reset_launch_counts()
        loss, counts, grads = step_grads(model, step, args)
        launches = {k: v for k, v in kernels.launch_counts.items() if v}
        step(TrainState.create(model, lr=TRAIN_LR), *args)
        sync()
        out.append((loss, counts, grads, {
            n: p.detach().clone() for n, p in model.named_parameters()},
            launches))
        del model, step
    (l0, c0, g0, p0, n0), (l1, c1, g1, p1, n1) = out
    gdiff = [n for n in g0 if not torch.equal(g0[n], g1[n])]
    pdiff = [n for n in p0 if not torch.equal(p0[n], p1[n])]
    want = {k: 2 * v if k in FORWARD_KERNELS else v for k, v in n0.items()}
    print(f"  {where}: loss {l0:.6f} without remat, {l1:.6f} with; counts "
          f"equal {bool(torch.equal(c0, c1))}; gradients differing "
          f"{len(gdiff)} of {len(g0)}; updated parameters differing "
          f"{len(pdiff)}; launches {n0} without, {n1} with", flush=True)
    for n in gdiff[:5]:
        print(f"    {n}: gradient max |diff| "
              f"{(g0[n] - g1[n]).abs().max().item():.3g} of max |g| "
              f"{g0[n].abs().max().item():.3g}", flush=True)
    check(l0 == l1 and torch.equal(c0, c1) and not gdiff and not pdiff,
          f"{where}: remat changed the step (first differing: "
          f"{(gdiff + pdiff)[:1]})")
    check(n1 == want, f"{where}: launches with remat {n1}, predicted {want}")
    return n0, n1


def phase_remat(dev):
    """``remat`` on the flagship's routes: the fused step on phase 9's
    batch (bf16), phase 14's non-fused step and one space-2 ``forward_sp``
    step (every shard on this card), each bit-equal with and without remat
    (:func:`remat_pair`); then the fused step with and without remat timed
    in turns (3 warm-up and REMAT_STEPS timed steps, twice each), peak
    memory beside each."""
    from unetsulc_tpu_torch.models.unet3d import UNet3D
    from unetsulc_tpu_torch.parallel import shard_x
    from unetsulc_tpu_torch.train.step import (TrainState, make_train_step,
                                               make_train_step_sp)

    x, labels = make_batch(dev)

    def flagship(remat):
        return UNet3D(in_channels=1, out_channels=CLASSES,
                      init_channel_number=64, device=dev, seed=0, remat=remat)

    def single(m):
        return make_train_step(m, CLASSES, momentum=0.9)

    mesh = sp_mesh(2)
    out = {
        "fused": remat_pair(flagship, single, (x, labels),
                            "fused step, bf16"),
        "nonfused": remat_pair(lambda r: nonfused_model(dev, remat=r), single,
                               (x, labels), "non-fused step (phase 14's)"),
        "sp": remat_pair(flagship,
                         lambda m: make_train_step_sp(m, CLASSES, mesh,
                                                      momentum=0.9),
                         (shard_x(x, mesh), shard_x(labels, mesh)),
                         "space-2 forward_sp step, one card"),
    }
    times = {False: [], True: []}
    for remat in (False, True, False, True):
        m = flagship(remat)
        ms, gb, curve = timed_steps(single(m), TrainState.create(m, lr=TRAIN_LR),
                                    (x, labels), REMAT_STEPS)
        check(bool(torch.isfinite(curve).all()), "remat timing: non-finite")
        times[remat].append((ms, gb))
        del m
    for remat, ts in times.items():
        print(f"fused train step 96^3 flagship bf16 {'with' if remat else 'without'}"
              f" remat: " + ", ".join(f"{ms:.2f} ms/step ({gb:.2f} GB peak)"
                                       for ms, gb in ts)
              + f" ({REMAT_STEPS} steps after {WARMUP} warm-up, two turns)",
              flush=True)
    out["times"] = times
    return out


def main():
    if not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke.py needs an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(2)
    from unetsulc_tpu_torch import kernels  # noqa: F401  (fails outside the repo)

    t0 = time.time()
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    print("phase 2: build", flush=True)
    phase_build()
    print("phase 3: kernel A against its plain version", flush=True)
    err_a = phase_conv_checks(dev)
    print("phase 4: kernel B against its plain version", flush=True)
    phase_pool_checks(dev)
    print("phase 5: the labelling path end to end", flush=True)
    model, x, counts, label_ms, fwd_ms = phase_end_to_end(dev)
    print("phase 6: kernel times over one flagship forward", flush=True)
    rows = phase_timing(model, x)
    print("phase 7: where one flagship forward's time goes", flush=True)
    phase_profile(model, x)
    del model, x
    print("phase 8: kernels C, D, E against their plain versions", flush=True)
    err_bwd = phase_backward_checks(dev)
    print("phase 9: the flagship training step", flush=True)
    train_launches, train, tmodel, step, xb, lb = phase_train(dev)
    print("phase 10: kernel times over one flagship training step's "
          "backward", flush=True)
    rows.update(phase_backward_timing(tmodel, step, xb, lb))
    del tmodel, step
    print("phase 12: GroupNorm kernels against their plain versions",
          flush=True)
    err_gn = phase_gn_checks(dev)
    print("phase 13: the non-fused labelling path end to end", flush=True)
    nf_counts, nf_label_ms, nf_fwd_ms = phase_nonfused_labelling(dev)
    print("phase 14: the non-fused training step", flush=True)
    nf_launches, nf_train, nmodel, nstep, xb, lb = phase_nonfused_train(dev)
    print("phase 15: GroupNorm kernel times over one non-fused training "
          "step", flush=True)
    rows.update(phase_gn_timing(nmodel, nstep, xb, lb))
    del nmodel, nstep
    print("phase 16: kernels A, C, D in halo mode against their plain "
          "versions", flush=True)
    err_halo = phase_halo_checks(dev)
    print("phase 17: the spatial-parallel training step (space 2 and 4, "
          "one card)", flush=True)
    sp_runs, (smodel, sstep, sxs, sls) = phase_sp_train(dev, train["peak_gb"])
    print("phase 18: halo-mode kernel times over one space-2 sp training "
          "step", flush=True)
    rows.update(phase_halo_timing(smodel, sstep, sxs, sls))
    del smodel, sstep, sxs, sls
    print("phase 19: the probe kernels against their plain versions",
          flush=True)
    err_probe = phase_probe_checks(dev)
    print("phase 20: the probe CLI and probe kernel times", flush=True)
    probe_counts, probe_rows = phase_probe(dev)
    print("phase 21: the training CLI end to end (3-fold CV, then transfer)",
          flush=True)
    experiments = phase_experiment(dev)
    print("phase 22: data and fold parallelism on one card; the CV train "
          "phase in parts", flush=True)
    dp_run = phase_dp_train(dev)
    folds_run = phase_fold_parallel(experiments["FlagshipCV"], dev)
    parts_run = phase_train_parts(experiments["FlagshipCV"])
    print("phase 23: the sharded GroupNorm modes and the sharded non-fused "
          "step (space 2 and 3, one card)", flush=True)
    t23 = time.time()
    err_gn_shard = phase_gn_shard_checks(dev)
    halo_runs, gn_calls = phase_halo_train(dev)
    rows.update(gn_shard_rows(gn_calls))
    del gn_calls
    print(f"  phase 23 took {time.time() - t23:.1f} s", flush=True)
    print("phase 24: the pattern classifier at full width; remat on the "
          "fused, non-fused and sp routes", flush=True)
    t24 = time.time()
    pattern, pattern_rows = phase_pattern(dev)
    remat = phase_remat(dev)
    print(f"  phase 24 took {time.time() - t24:.1f} s", flush=True)

    gn_src = "unetsulc_tpu_torch/csrc/group_norm.cu"
    gn_cover = "one 96^3 non-fused flagship training step"
    sp_cover = "one 96^3 flagship sp training step, space 2, one card"
    meta = {
        "conv3x3x3_fwd": ("unetsulc_tpu_torch/csrc/conv3x3x3_fwd.cu",
                          "unetsulc_tpu/ops/conv_pallas.py:370", "operations",
                          "one 96^3 flagship forward"),
        "max_pool_buf_fwd": ("unetsulc_tpu_torch/csrc/max_pool_buf_fwd.cu",
                             "unetsulc_tpu/ops/conv_pallas.py:1653", "bytes",
                             "one 96^3 flagship forward"),
        "conv3x3x3_dx": ("unetsulc_tpu_torch/csrc/conv3x3x3_dx.cu",
                         "unetsulc_tpu/ops/conv_pallas.py:370", "operations",
                         "one 96^3 flagship training step"),
        "conv3x3x3_wgrad": ("unetsulc_tpu_torch/csrc/conv3x3x3_wgrad.cu",
                            "unetsulc_tpu/ops/conv_pallas.py:1090",
                            "operations", "one 96^3 flagship training step"),
        "max_pool_buf_bwd": ("unetsulc_tpu_torch/csrc/max_pool_buf_bwd.cu",
                             "unetsulc_tpu/ops/conv_pallas.py:1695", "bytes",
                             "one 96^3 flagship training step"),
        # gn_stats and gn_apply together replace groupnorm_pallas.py:41;
        # each also replaces one chunked kernel (:44, :69)
        "gn_stats": (gn_src, "unetsulc_tpu/ops/groupnorm_pallas.py:41",
                     "bytes", gn_cover),
        "gn_apply": (gn_src, "unetsulc_tpu/ops/attic/"
                     "groupnorm_pallas_chunked.py:69", "bytes", gn_cover),
        "gn_bwd_reduce": (gn_src, "unetsulc_tpu/ops/attic/"
                          "groupnorm_pallas_chunked.py:145", "bytes",
                          gn_cover),
        "gn_bwd_dx": (gn_src, "unetsulc_tpu/ops/attic/"
                      "groupnorm_pallas_chunked.py:183", "bytes", gn_cover),
        # row 6: the halo / valid_in / valid_out / edge_outputs modes
        "conv3x3x3_fwd_halo": ("unetsulc_tpu_torch/csrc/conv3x3x3_fwd.cu",
                               "unetsulc_tpu/ops/conv_pallas.py:370",
                               "operations", sp_cover),
        "conv3x3x3_dx_halo": ("unetsulc_tpu_torch/csrc/conv3x3x3_dx.cu",
                              "unetsulc_tpu/ops/conv_pallas.py:370",
                              "operations", sp_cover),
        "conv3x3x3_wgrad_halo": ("unetsulc_tpu_torch/csrc/conv3x3x3_wgrad.cu",
                                 "unetsulc_tpu/ops/conv_pallas.py:1090",
                                 "operations", sp_cover),
        # the sharded GroupNorm (phase 23): the stats kernel's sums and its
        # finalize, the dx kernel with the global count
        "gn_stats_sums": (gn_src, "unetsulc_tpu/ops/attic/"
                          "groupnorm_pallas_chunked.py:44", "bytes",
                          HALO_COVER),
        "gn_finalize": (gn_src, "unetsulc_tpu/ops/attic/"
                        "groupnorm_pallas_chunked.py:44", "bytes",
                        HALO_COVER),
        "gn_bwd_dx_denom": (gn_src, "unetsulc_tpu/ops/attic/"
                            "groupnorm_pallas_chunked.py:183", "bytes",
                            HALO_COVER),
    }
    # launches on the main paths: A and B on the fused labelling path
    # (phase 5), C, D and E per fused training step (phase 9), gn_stats and
    # gn_apply on the non-fused labelling path (phase 13), the GroupNorm
    # backward per non-fused training step (phase 14)
    main_counts = {**{k: counts[k] for k in
                      ("conv3x3x3_fwd", "max_pool_buf_fwd")},
                   **{k: train_launches[k] for k in
                      ("conv3x3x3_dx", "conv3x3x3_wgrad", "max_pool_buf_bwd")},
                   **{k: nf_counts[k] for k in ("gn_stats", "gn_apply")},
                   **{k: nf_launches[k] for k in
                      ("gn_bwd_reduce", "gn_bwd_dx")},
                   **{k: sp_runs[SPACES[0]]["launches"][k]
                      for k in HALO_KERNELS},
                   **{k: halo_runs[HALO_SPACES[0]]["launches"][k]
                      for k in GN_SHARD_KERNELS}}
    line = []
    for name, (src, replaces, bound_by, cover) in meta.items():
        rs = rows[name]
        err = max(r["max_abs_err"] for r in rs)
        if name == "conv3x3x3_fwd":
            err = max(err, err_a)
        err = max(err, err_bwd.get(name, 0.0), err_gn.get(name, 0.0),
                  err_halo.get(name, 0.0), err_gn_shard.get(name, 0.0))
        per_step = (nf_launches if name in GN_KERNELS else
                    sp_runs[SPACES[0]]["launches"] if name in HALO_KERNELS
                    else halo_runs[HALO_SPACES[0]]["launches"]
                    if name in GN_SHARD_KERNELS else train_launches)
        extra = {}
        if name in GN_SHARD_KERNELS:
            extra = dict(launches_space3=halo_runs[3]["launches"][name],
                         library_note="no PyTorch call computes a shard's "
                         "sums, the finalize alone, or dx from other "
                         "shards' sums")
        if name in HALO_KERNELS:
            extra = dict(launches_space4=sp_runs[4]["launches"][name],
                         nohalo_ms=sum(r["nohalo_ms"] for r in rs))
        if name == "conv3x3x3_wgrad":
            extra = dict(library_batch_stride_c_ms=sum(
                r["library_batch_stride_c_ms"] for r in rs))
        for key in ("library_view_ms", "memset_ms", "memset_alone_ms",
                    "copy_ms"):
            if key in rs[0]:
                extra[key] = sum(r[key] for r in rs)
        if name in GN_KERNELS:
            prs = pattern_rows[name]
            extra.update(
                launches_pattern_step=pattern["launches"][name],
                pattern_step_ms=sum(r["ms"] for r in prs),
                pattern_step_bound_ms=sum(r["bound_ms"] for r in prs),
                pattern_step_library_ms=sum(r["library_ms"] for r in prs))
        if name in remat["fused"][1]:
            extra["launches_remat_step"] = remat["fused"][1][name]
        line.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": main_counts[name],
            "launches_per_train_step": per_step[name], **extra,
            "max_abs_err": err,
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": bound_by,
            "library_ms": (None if rs[0]["library_ms"] is None
                           else sum(r["library_ms"] for r in rs)),
            "timed_launches": len(rs),
            "times_cover": cover,
        })
    probe_cover = "one probe run (ps 10976, 200 dots or builds per launch)"
    for name in PROBE_KERNELS:
        rs = probe_rows[name]
        line.append({
            "name": name, "route": "cuda",
            "source": "unetsulc_tpu_torch/csrc/mxu_probe.cu",
            "replaces": PROBE_REPLACES[name],
            "launches": probe_counts[name],
            "max_abs_err": max(err_probe[name],
                               max(r["max_abs_err"] for r in rs)),
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": rs[0]["bound_by"],
            "library_ms": (None if rs[0]["library_ms"] is None
                           else sum(r["library_ms"] for r in rs)),
            "timed_launches": len(rs),
            "times_cover": probe_cover,
            **({"steady_ms": sum(r["steady_ms"] for r in rs)}
               if "steady_ms" in rs[0] else {}),
            **({"bound_note": "shared-memory bytes at 128 B per clock on "
                "each SM at clocks.max.sm"} if name == "slab_build" else {}),
        })
    for name, e in experiments.items():
        print(f"experiment {name}: train phase {e['train_s']:.3f} s per epoch "
              f"(4 volumes), {e['voxels_per_sec']:,.0f} voxels/s, volumes "
              f"{e['extents']}, main() {e['wall_s']:.1f} s", flush=True)
    print(f"label latency {label_ms:.1f} ms/graph, forward {fwd_ms:.2f} ms, "
          f"train step {train['step_ms']:.2f} ms; non-fused: label latency "
          f"{nf_label_ms:.1f} ms/graph, forward {nf_fwd_ms:.2f} ms, train "
          f"step {nf_train['step_ms']:.2f} ms; sp train step "
          + ", ".join(f"space {n} {r['step_ms']:.2f} ms ({r['peak_gb']:.2f} GB "
                      f"peak, single-device step {r['single_peak_gb']:.2f} GB "
                      "measured alike)" for n, r in sp_runs.items())
          + f"; dp train step (batch 2, data 2, one card) "
          f"{dp_run['step_ms']:.2f} ms ({dp_run['peak_gb']:.2f} GB; "
          f"single-device batch 2 {dp_run['single_ms']:.2f} ms, "
          f"{dp_run['single_gb']:.2f} GB; bit-equal {dp_run['bit_equal']}); "
          f"fold_parallel 2 CV main() {folds_run['wall_s']:.1f} s against "
          f"{folds_run['seq_wall_s']:.1f} s; voxelizer native "
          f"{parts_run['native_ms']:.2f} ms against numpy "
          f"{parts_run['numpy_ms']:.2f} ms per volume; sharded non-fused "
          "train step (one card) "
          + ", ".join(f"space {n} {halo_runs[n]['step_ms']:.2f} ms "
                      f"({halo_runs[n]['peak_gb']:.2f} GB)"
                      for n in HALO_SPACES)
          + f" against the single-device non-fused step "
          f"{halo_runs[2]['single_ms']:.2f} ms "
          f"({halo_runs[2]['single_gb']:.2f} GB)"
          + f"; pattern step {pattern['step_ms']:.2f} ms "
          f"({pattern['peak_gb']:.2f} GB), trainer {pattern['train_s']:.1f} s "
          f"to best eval accuracy {pattern['best_acc']:.3f}; fused step with "
          "remat " + ", ".join(f"{ms:.2f}" for ms, _ in remat["times"][True])
          + " ms against " + ", ".join(f"{ms:.2f}"
                                       for ms, _ in remat["times"][False])
          + f" without; total script {time.time() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
