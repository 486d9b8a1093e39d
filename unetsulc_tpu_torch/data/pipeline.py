"""Host input pipeline: dataset -> static-shape batches -> the device,
prefetched (counterpart of ``unetsulc_tpu/data/pipeline.py``).

Replaces the reference's ``torch.utils.data.DataLoader(..., shuffle=False,
num_workers=0)`` (ref training.py:92-94,116-118):

* with a fixed ``img_size`` every batch has the same shape; a short last
  batch is padded with all-background samples, which carry zero weight in
  the masked loss and metrics (``real`` in each batch is the true sample
  count, for the reference's ``running_loss += loss * B`` accounting);
* at batch 1 each sample goes to its cubic shape bucket, so small samples
  do not pay the cohort's largest volume; at batch > 1 without a fixed
  size, samples are grouped by bucket;
* :func:`device_iterator` voxelizes the next batches in a background
  thread, into pinned host memory, and copies them to the card with
  ``non_blocking`` copies on a stream of their own, so the host's work and
  the copies overlap the steps.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from unetsulc_tpu_torch.utils.profiling import HostSpans, span


@dataclass
class Batch:
    inputs: np.ndarray  # (B, X, Y, Z, 1) float32
    labels: np.ndarray  # (B, X, Y, Z) int32
    real: int  # number of non-padding samples


def iterate_batches(
    dataset,
    batch_size: int,
    img_size: Optional[Sequence[int]] = None,
    epoch: int = 0,
    alloc_batch: Optional[int] = None,
) -> Iterator[Batch]:
    """Yield batches in dataset order (reference: shuffle=False), each
    sample voxelized for ``epoch``'s augmentation draw.

    ``img_size`` given: every batch (B, *img_size); a short last batch is
    padded with all-background samples. ``img_size=None``: per-sample cubic
    shape buckets (``data.voxelize.DEFAULT_BUCKET_SIZES``): a sample is
    voxelized at its exact extent and padded up to the smallest bucket
    that holds its largest axis, so small samples do not pay the cohort's
    largest volume (the counterpart of the reference's batch-1 dynamic
    shapes, ref dataset.py:74-77). At batch 1 each sample is its own batch;
    at batch > 1 samples are grouped by bucket (which reorders them within
    the epoch), each group cut into padded batches.

    ``alloc_batch`` (>= ``batch_size``) pads every batch's leading axis to
    that many samples with all-background ones, which are exactly neutral
    in the masked loss and the counts: a data-parallel batch must split
    evenly over the mesh's ``data`` rows. With it, batch-1 buckets go
    through the grouped path, one sample per batch.
    """
    if hasattr(dataset, "set_epoch"):
        dataset.set_epoch(epoch)
    n = len(dataset)
    alloc = alloc_batch or batch_size
    if alloc < batch_size:
        raise ValueError(f"alloc_batch {alloc} < batch_size {batch_size}")

    def batch(idxs, size):
        inputs = np.zeros((alloc, *size, 1), np.float32)
        labels = np.full(inputs.shape[:4], -1, np.int32)
        for bi, i in enumerate(idxs):
            vol_in, vol_lb = dataset[i]
            sx, sy, sz = vol_in.shape[:3]
            if img_size is not None and (sx, sy, sz) != tuple(size):
                raise ValueError(
                    f"sample {i} shape {(sx, sy, sz)} != static {tuple(size)}; "
                    "choose img_size >= dataset.max_image_size()")
            inputs[bi, :sx, :sy, :sz] = vol_in
            labels[bi, :sx, :sy, :sz] = vol_lb
        return Batch(inputs=inputs, labels=labels, real=len(idxs))

    if img_size is not None:
        size = tuple(int(s) for s in img_size)
        for start in range(0, n, batch_size):
            yield batch(range(start, min(start + batch_size, n)), size)
        return
    from unetsulc_tpu_torch.data.voxelize import bucket_size

    if batch_size == 1 and alloc == 1:
        for i in range(n):
            # voxelized once: its extent gives the bucket
            vol_in, vol_lb = dataset[i]
            b = bucket_size(max(vol_in.shape[:3]))
            inputs = np.zeros((1, b, b, b, 1), np.float32)
            labels = np.full((1, b, b, b), -1, np.int32)
            sx, sy, sz = vol_in.shape[:3]
            inputs[0, :sx, :sy, :sz] = vol_in
            labels[0, :sx, :sy, :sz] = vol_lb
            yield Batch(inputs=inputs, labels=labels, real=1)
        return
    groups: dict = {}
    for i in range(n):
        groups.setdefault(bucket_size(dataset.sample_extent(i)), []).append(i)
    for b in sorted(groups):
        idxs = groups[b]
        for start in range(0, len(idxs), batch_size):
            yield batch(idxs[start:start + batch_size], (b, b, b))


def device_iterator(
    batches: Iterator[Batch],
    device,
    prefetch: int = 2,
    stream: Optional["torch.cuda.Stream"] = None,
    spans: Optional[HostSpans] = None,
):
    """Yield ``(inputs, labels, real)`` on ``device``: inputs (B, X, Y, Z,
    1) float32, labels (B, X, Y, Z) int64.

    On CUDA each batch is copied from pinned host memory with
    ``non_blocking`` copies on ``stream`` (a side stream of the device's
    when None); the consumer's stream waits for the copy's event before the
    tensors are yielded, so the step that reads them is ordered after it.
    With ``prefetch > 0`` a background thread voxelizes and uploads up to
    ``prefetch`` batches ahead of the consumer; ``prefetch <= 0`` does it
    all in the caller's thread, one batch at a time. ``spans`` times the
    parts on the host (:class:`~unetsulc_tpu_torch.utils.profiling.HostSpans`):
    ``batch`` (making the next batch), ``pin``, ``upload`` (enqueueing the
    copies) and the consumer's ``wait`` for a batch."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card and stream is None:
        stream = torch.cuda.Stream(device)

    def made(batches):
        it = iter(batches)
        while True:
            with span(spans, "batch"):
                b = next(it, None)
            if b is None:
                return
            yield b

    batches = made(batches)

    def put(batch: Batch):
        inp = torch.from_numpy(batch.inputs)
        lab = torch.from_numpy(batch.labels)
        if not on_card:
            return inp.to(device), lab.to(device, torch.int64), batch.real, None
        with span(spans, "pin"):
            inp, lab = inp.pin_memory(), lab.pin_memory()
        with span(spans, "upload"), torch.cuda.stream(stream):
            inp_d = inp.to(device, non_blocking=True)
            lab_d = lab.to(device, non_blocking=True).long()
            done = torch.cuda.Event()
            done.record(stream)
        return inp_d, lab_d, batch.real, done

    def hand_over(item):
        inp, lab, real, done = item
        if done is not None:
            cur = torch.cuda.current_stream(device)
            cur.wait_event(done)
            # the tensors were allocated on the copy stream: keep their
            # memory until the consumer's stream is done with them
            inp.record_stream(cur)
            lab.record_stream(cur)
        return inp, lab, real

    if prefetch <= 0:
        for b in batches:
            yield hand_over(put(b))
        return

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    _END = object()
    err = []

    def producer():
        try:
            for b in batches:
                q.put(put(b))
        except BaseException as e:  # surfaced in the consumer
            err.append(e)
        finally:
            q.put(_END)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        with span(spans, "wait"):
            item = q.get()
        if item is _END:
            if err:
                raise err[0]
            return
        yield hand_over(item)


def choose_static_size(
    dataset,
    buckets: Optional[Sequence[int]] = None,
    num_epochs: Optional[int] = None,
) -> tuple:
    """Static (X, Y, Z) for a dataset: its max size, bucketed.

    ``num_epochs`` enables the exact replayable-stream scan for train
    datasets (see SulciDataset.max_image_size)."""
    from unetsulc_tpu_torch.data.voxelize import DEFAULT_BUCKET_SIZES, bucket_shape

    size = dataset.max_image_size(num_epochs=num_epochs)
    return bucket_shape(size, buckets or DEFAULT_BUCKET_SIZES)
