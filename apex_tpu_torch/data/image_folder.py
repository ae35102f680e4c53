"""ImageFolder dataset + DP-sharded loader (port of
:mod:`apex_tpu.data.image_folder`).

Behavioral spec: the reference imagenet example's input pipeline —
``examples/imagenet/main_amp.py:207-232`` (``datasets.ImageFolder`` with
``RandomResizedCrop`` + ``RandomHorizontalFlip`` train transforms,
``Resize``+``CenterCrop`` eval transforms, ``DistributedSampler`` for DP
sharding) and ``fast_collate`` (``:48-63``), which batches *uint8* tensors
and defers mean/std normalization to the accelerator
(``data_prefetcher``, ``:256-276``).

As in the JAX package:

- batches are NHWC uint8 across the host->device hop (4x less traffic
  than fp32); :func:`normalize_on_device` runs on the card inside the
  step, and a normalized batch's ``permute(0, 3, 1, 2)`` is the model's
  channels-last ``[N, C, H, W]`` input with no copy;
- DP sharding reuses the Megatron samplers
  (:mod:`apex_tpu_torch.transformer._data`) so ``consumed_samples``
  checkpoint resume works for vision runs too; ``dp_ranks`` restricts a
  loader to the dp shards this process owns;
- decode parallelism is selectable (``backend=``): a **process pool**
  (spawned workers, the true ``DataLoader(num_workers=...)`` analog) or a
  **thread pool**.  Per-image decode prefers the native C kernel
  (``apex_tpu_torch/_native/jpegdec.c``, DCT-scaled libjpeg decode fused
  with the crop + bilinear resize) and falls back to PIL per image; the
  decode core is a module-level pure function over an immutable
  :class:`_DecodeSpec`, so both backends run byte-identical code and the
  augmentation stream (numpy ``RandomState`` draws, the reference's) is
  backend-independent;
- batches are decoded ``prefetch`` steps ahead; ``consumed_samples``
  always reflects batches *yielded*, so checkpoint resume stays exact.

This module imports neither torch nor anything that does (torch is
imported inside :func:`normalize_on_device`): a spawned decode worker
unpickles its functions and its :class:`ImageFolder` from here, and must
not pay torch's and the CUDA runtime's import.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import Iterator, NamedTuple, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "ImageFolder",
    "ImageFolderLoader",
    "center_crop_resize",
    "normalize_on_device",
    "random_resized_crop",
    "sample_crop_box",
    "synthetic_image_batches",
]

IMAGENET_MEAN = (0.485, 0.456, 0.406)  # main_amp.py:251-252
IMAGENET_STD = (0.229, 0.224, 0.225)

_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


class ImageFolder:
    """``root/class_x/img.jpg`` directory dataset.

    Classes are the sorted subdirectory names mapped to contiguous indices
    (torchvision's ``ImageFolder`` contract, which the reference trains
    on); samples are lexicographically ordered within a class so the
    index->sample mapping is deterministic across processes.
    """

    def __init__(self, root: str,
                 extensions: Sequence[str] = _EXTENSIONS):
        self.root = root
        self.classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        if not self.classes:
            raise ValueError(f"no class subdirectories under {root!r}")
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples: list = []
        exts = tuple(e.lower() for e in extensions)
        for cls in self.classes:
            cdir = os.path.join(root, cls)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(exts):
                    self.samples.append(
                        (os.path.join(cdir, fname), self.class_to_idx[cls]))
        if not self.samples:
            raise ValueError(f"no images found under {root!r}")

    def __len__(self) -> int:
        return len(self.samples)

    def load(self, index: int):
        """Decode one sample -> (PIL RGB image, label)."""
        from PIL import Image

        path, label = self.samples[index]
        with Image.open(path) as img:
            return img.convert("RGB"), label


def sample_crop_box(rng: np.random.RandomState, w: int, h: int,
                    scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)
                    ) -> Tuple[int, int, int, int]:
    """``RandomResizedCrop``'s box sampler -> ``(x0, y0, cw, ch)`` in
    source coordinates.  After 10 rejected draws it falls back to
    torchvision's ratio-clamped center crop (the whole image when its
    aspect ratio is inside ``ratio``, else the largest in-bounds region).
    Shared by the PIL and native decode paths so both consume the *same*
    RNG draw sequence — the augmentation stream is identical whichever
    path decodes."""
    area = w * h
    for _ in range(10):
        target = area * rng.uniform(*scale)
        log_r = rng.uniform(np.log(ratio[0]), np.log(ratio[1]))
        ar = np.exp(log_r)
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            x0 = rng.randint(0, w - cw + 1)
            y0 = rng.randint(0, h - ch + 1)
            return x0, y0, cw, ch
    in_ratio = w / h
    if in_ratio < min(ratio):
        cw = w
        ch = int(round(cw / min(ratio)))
    elif in_ratio > max(ratio):
        ch = h
        cw = int(round(ch * max(ratio)))
    else:
        cw, ch = w, h
    return (w - cw) // 2, (h - ch) // 2, cw, ch


def random_resized_crop(rng: np.random.RandomState, img, size: int,
                        scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                        flip: bool = True) -> np.ndarray:
    """``RandomResizedCrop(size)`` + ``RandomHorizontalFlip`` -> uint8
    HWC (the reference's train transform, ``main_amp.py:209-214``)."""
    from PIL import Image

    w, h = img.size
    x0, y0, cw, ch = sample_crop_box(rng, w, h, scale, ratio)
    img = img.crop((x0, y0, x0 + cw, y0 + ch))
    img = img.resize((size, size), Image.BILINEAR)
    out = np.asarray(img, np.uint8)
    if flip and rng.rand() < 0.5:
        out = out[:, ::-1]
    return out


def center_crop(img, crop: int):
    w, h = img.size
    x0 = (w - crop) // 2
    y0 = (h - crop) // 2
    return img.crop((x0, y0, x0 + crop, y0 + crop))


def _default_eval_resize(size: int) -> int:
    """The eval transform's short-side resize for a given crop size —
    256 for the canonical 224 (``main_amp.py:216-219``).  One definition
    shared by the PIL and native eval paths so they cannot skew."""
    return int(size * 256 / 224)


def eval_crop_box(w: int, h: int, size: int,
                  resize: Optional[int] = None) -> Tuple[int, int, int]:
    """Source-coordinate square ``(x0, y0, side)`` that the eval
    transform ``Resize(resize)`` + ``CenterCrop(size)`` keeps.  The
    native decode path crops this region and resizes straight to
    ``(size, size)``; :func:`center_crop_resize` realizes the same
    geometry through PIL's resize-then-crop."""
    resize = resize or _default_eval_resize(size)
    short = min(w, h)
    side = min(int(round(short * size / resize)), short)
    return (w - side) // 2, (h - side) // 2, side


def center_crop_resize(img, size: int, resize: Optional[int] = None
                       ) -> np.ndarray:
    """``Resize(resize)`` + ``CenterCrop(size)`` -> uint8 HWC (the
    reference's eval transform, ``main_amp.py:216-219``)."""
    from PIL import Image

    resize = resize or _default_eval_resize(size)
    w, h = img.size
    short = min(w, h)
    img = img.resize((int(round(w * resize / short)),
                      int(round(h * resize / short))), Image.BILINEAR)
    return np.asarray(center_crop(img, size), np.uint8)


def normalize_on_device(x_uint8, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                        dtype=None):
    """uint8 ``[..., C]`` images to ``(x / 255 - mean) / std`` in ``dtype``
    (default fp32), computed on ``x_uint8``'s device in that dtype, as the
    reference computes it (the reference prefetcher's GPU-side
    ``sub_(mean).div_(std)``, ``main_amp.py:268-276``)."""
    import torch

    dtype = dtype or torch.float32
    dev = x_uint8.device
    x = x_uint8.to(dtype) / torch.tensor(255.0, dtype=dtype, device=dev)
    mean = torch.tensor(mean, dtype=dtype, device=dev)
    std = torch.tensor(std, dtype=dtype, device=dev)
    return (x - mean) / std


# ---------------------------------------------------------------------------
# Decode core — module-level pure functions over an immutable spec, so the
# thread backend, the process backend (pickled to spawned workers), and the
# data-service loader processes all run byte-identical decode code.
# ---------------------------------------------------------------------------


class _DecodeSpec(NamedTuple):
    """Everything one decode needs, shipped once per worker process.

    ``dataset`` is the ImageFolder (or any duck-type exposing
    ``samples`` — the ``(path, label)`` list the native fast path and
    the samplers index — and ``load(i) -> (PIL image, label)``, the
    authoritative decode the PIL path calls, so custom datasets that
    override ``load`` keep working on every backend).  The process
    backend pickles it once per worker via the pool initializer, so a
    custom dataset must be picklable there."""

    dataset: object      # .samples + .load(i)
    image_size: int
    train: bool
    seed: int
    native: bool


def _decode_native_one(spec: _DecodeSpec, index: int,
                       rng: Optional[np.random.RandomState]
                       ) -> Optional[Tuple[np.ndarray, int]]:
    """One-call C decode+crop+resize (``apex_tpu_torch/_native/jpegdec.c``) — DCT
    scaled decode fused with the transform, ~2x a PIL worker on the
    same core.  Returns ``None`` (caller decodes via PIL) for
    non-JPEG files or any per-image failure.  Draws the crop box
    from the SAME :func:`sample_crop_box` stream as the PIL path, so
    augmentation determinism is path-independent."""
    from apex_tpu_torch.data import _jpeg_native

    path, label = spec.dataset.samples[index]
    if not path.lower().endswith((".jpg", ".jpeg")):
        return None
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    dims = _jpeg_native.jpeg_dims(data)
    if dims is None:
        return None
    h, w = dims
    size = spec.image_size
    if rng is not None:  # train transform
        x0, y0, cw, ch = sample_crop_box(rng, w, h)
        flip = bool(rng.rand() < 0.5)
    else:  # eval: the region center_crop_resize would keep
        x0, y0, side = eval_crop_box(w, h, size)
        cw = ch = side
        flip = False
    arr = _jpeg_native.decode_crop_resize(
        data, y0, x0, ch, cw, size, size, hflip=flip)
    if arr is None:
        return None
    return arr, label


def _decode_one(spec: _DecodeSpec, index: int, consumed_marker: int
                ) -> Tuple[np.ndarray, int]:
    """Decode + transform one sample.  Pure in ``(spec, index, marker)``
    — the augmentation seed folds the sampler position captured at
    submission time, so the stream is identical at every prefetch depth
    and on every backend."""
    if spec.train:
        # fold the sample index + sampler position into the seed:
        # deterministic but different augmentation per sample and epoch.
        rng = np.random.RandomState(
            (spec.seed + consumed_marker + index) % (2 ** 31))
    else:
        rng = None
    if spec.native:
        # snapshot the RNG: a native failure *after* the crop draws
        # (e.g. truncated file) must hand PIL the same stream it
        # would have seen had the native path never run
        state = rng.get_state() if rng is not None else None
        out = _decode_native_one(spec, index, rng)
        if out is not None:
            return out
        if state is not None:
            rng.set_state(state)
    # the dataset's load() is authoritative (custom datasets override it)
    img, label = spec.dataset.load(index)
    if spec.train:
        arr = random_resized_crop(rng, img, spec.image_size)
    else:
        arr = center_crop_resize(img, spec.image_size)
    return arr, label


# Spawned decode workers hold the spec in a module global (set once by the
# pool initializer) so tasks ship only (index, marker), not the spec.
_WORKER_SPEC: Optional[_DecodeSpec] = None


def _process_worker_init(spec: _DecodeSpec) -> None:
    global _WORKER_SPEC
    _WORKER_SPEC = spec


def _process_decode_chunk(indices, marker: int):
    """Decode a chunk of samples in one task — amortizes the per-task
    submit/pickle round trip (per-image tasks spend a measurable
    fraction of a wide pool's budget on IPC, not decode).  The images
    are stacked into ONE uint8 array so the result pickles as a single
    contiguous buffer."""
    outs = [_decode_one(_WORKER_SPEC, i, marker) for i in indices]
    return (np.stack([o[0] for o in outs]),
            np.asarray([o[1] for o in outs], np.int32))


def _worker_warmup() -> bool:
    """Pull the decode imports into a worker and hold it briefly so the
    pool spawns its full width (ProcessPoolExecutor adds processes only
    while a backlog exists)."""
    import time

    import PIL.Image  # noqa: F401 — the import IS the warmup

    time.sleep(0.05)
    return True


class ImageFolderLoader:
    """DP-sharded training iterator over an :class:`ImageFolder`.

    Yields ``(images uint8 [B, size, size, 3], labels int32 [B])``
    batches where ``B = local_batch * len(dp_ranks)`` and row window
    ``[i*local : (i+1)*local]`` is ``dp_ranks[i]``'s disjoint shard (the
    ``DistributedSampler`` contract).  ``dp_ranks`` defaults to ALL dp
    ranks (single-host: the global batch — feed the tuple to
    ``parallel.dp_shard_batch``); a multi-process job passes
    ``parallel.host_dp_ranks(mesh)`` so each host decodes only its own
    shards and places them with
    ``dp_shard_batch(batch, mesh, local_ranks=dp_ranks)``.
    ``consumed_samples`` stays in GLOBAL samples on every host (each
    yielded batch advances it by ``local_batch * data_parallel_size``),
    so a single checkpointed integer resumes all hosts coherently.

    ``backend``: ``"process"`` (spawned worker processes — the true
    ``DataLoader(num_workers=...)`` analog, immune to the GIL; decode
    state ships once per worker via the pool initializer) or
    ``"thread"`` (in-process pool — lower fixed cost; both decode paths
    release the GIL for the codec work but contend for it in the numpy
    glue).  Epoch shuffling and mid-epoch resume come from
    :class:`~apex_tpu_torch.transformer._data.MegatronPretrainingRandomSampler`.
    """

    def __init__(self, dataset: ImageFolder, local_batch: int,
                 data_parallel_size: int = 1, image_size: int = 224,
                 consumed_samples: int = 0, train: bool = True,
                 workers: int = 8, seed: int = 0, prefetch: int = 2,
                 native: Optional[bool] = None, backend: str = "thread",
                 dp_ranks: Optional[Sequence[int]] = None,
                 mp_start: str = "spawn"):
        self.dataset = dataset
        self.local_batch = local_batch
        self.dp = data_parallel_size
        self.image_size = image_size
        self.train = train
        self.seed = seed
        self.prefetch = max(0, prefetch)
        if backend not in ("thread", "process"):
            raise ValueError(
                f"backend must be 'thread' or 'process', got {backend!r}")
        self.backend = backend
        # native=None -> auto: the C decode kernel when it builds (cc +
        # libjpeg present), PIL otherwise; failures of either the build
        # or any single image fall back to PIL per-image.  An explicit
        # native=True warns when the kernel is unavailable so an A/B
        # comparison cannot silently run PIL on both sides.
        if native is None or native:
            from apex_tpu_torch.data import _jpeg_native
            self._native = _jpeg_native.native_available()
            if native and not self._native:
                import warnings
                warnings.warn(
                    "ImageFolderLoader(native=True): native JPEG kernel "
                    "unavailable (no cc or libjpeg?); decoding via PIL")
        else:
            self._native = False
        self._spec = _DecodeSpec(
            dataset=dataset, image_size=image_size,
            train=train, seed=seed, native=self._native)
        self._workers = workers
        self._inflight = 0  # batches decoded/decoding ahead of the caller
        # Guards the sampler-advance + _inflight bookkeeping: under the
        # documented loader -> prefetch_to_device stack, the TRANSFER
        # thread drives this loader's generator while the trainer thread
        # reads consumed_samples for a checkpoint — an unlocked read
        # could tear between the sampler advance and the _inflight
        # increment and over-count by one undelivered batch.
        self._count_lock = threading.Lock()
        if backend == "process":
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor

            # spawn (not fork): the parent holds live CUDA and decode
            # threads, and a forked child inheriting their locks can
            # deadlock; spawned workers import only this torch-free
            # module and receive the spec once via the initializer.
            self._pool = ProcessPoolExecutor(
                max_workers=workers,
                mp_context=mp.get_context(mp_start),
                initializer=_process_worker_init,
                initargs=(self._spec,))
        else:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=workers)
        from apex_tpu_torch.data._producer import make_dp_samplers

        self.dp_ranks, self.samplers = make_dp_samplers(
            len(dataset), local_batch, data_parallel_size,
            consumed_samples, dp_ranks)

    @property
    def consumed_samples(self) -> int:
        """GLOBAL samples in batches already *yielded* to the caller.
        The samplers themselves run ``prefetch`` batches ahead; in-flight
        (decoding, not yet delivered) batches are subtracted so a
        checkpoint taken mid-epoch resumes at the first undelivered
        batch."""
        with self._count_lock:
            return (self.samplers[0].consumed_samples
                    - self._inflight * self.local_batch * self.dp)

    def rewind_batches(self, n: int) -> None:
        """Roll the samplers back ``n`` yielded batches — the resume
        surface :class:`~apex_tpu_torch.data.prefetch.DevicePrefetcher` uses
        on ``close()`` so undelivered device-queued batches are replayed
        rather than lost."""
        with self._count_lock:
            for s in self.samplers:
                s.consumed_samples -= n * self.local_batch * self.dp

    def warm_up(self) -> "ImageFolderLoader":
        """Spin the decode pool to full width before the first batch.
        For the process backend this pays the worker spawn + import cost
        (~1-2 s for a wide pool) up front instead of inside step 1 — the
        ``DataLoader(persistent_workers=True)`` warm-start analog.  Cheap
        no-op-ish for threads.  Returns self (chainable)."""
        import concurrent.futures as cf

        if self.backend == "process":
            futs = [self._pool.submit(_worker_warmup)
                    for _ in range(self._workers)]
        else:
            futs = [self._pool.submit(bool) for _ in range(self._workers)]
        cf.wait(futs, timeout=120.0)
        return self

    def close(self, timeout: float = 10.0) -> None:
        """Shut down the decode pool (idempotent).  Loaders are also
        context managers; without either, a thread pool's threads — or a
        process pool's workers — live for the rest of the process.

        Process workers are reaped with a BOUNDED wait: join up to
        ``timeout`` seconds, then escalate terminate -> kill (the
        DataService.close discipline) — a worker wedged in an
        uninterruptible NFS/FUSE read must not hang trainer shutdown
        (or a preemption-driven teardown) forever."""
        # snapshot the worker handles BEFORE shutdown (the executor's
        # management thread clears its process table as workers exit)
        procs = (list((getattr(self._pool, "_processes", None) or {})
                      .values())
                 if self.backend == "process" else [])
        self._pool.shutdown(wait=False, cancel_futures=True)
        if self.backend != "process":
            return
        import time

        from apex_tpu_torch.data._producer import reap_process

        deadline = time.monotonic() + timeout
        for p in procs:
            reap_process(p, deadline - time.monotonic(),
                         what="decode worker")

    def __enter__(self) -> "ImageFolderLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # best-effort backstop
        try:
            self._pool.shutdown(wait=False, cancel_futures=True)
        except Exception:
            pass

    def _submit_batch(self, indices, marker: int) -> list:
        """Fan one batch's decode out over the pool.  Threads get
        per-image tasks (fine-grained, no IPC); processes get ~2 chunks
        per worker (each task's result pickles as one contiguous stack —
        per-image IPC round trips cost a wide pool real throughput)."""
        if self.backend == "process":
            per = max(1, -(-len(indices) // (2 * self._workers)))
            return [self._pool.submit(
                        _process_decode_chunk, indices[o:o + per], marker)
                    for o in range(0, len(indices), per)]
        return [self._pool.submit(_decode_one, self._spec, i, marker)
                for i in indices]

    def _assemble(self, futs: list) -> Tuple[np.ndarray, np.ndarray]:
        if self.backend == "process":
            chunks = [f.result() for f in futs]
            return (np.concatenate([c[0] for c in chunks]),
                    np.concatenate([c[1] for c in chunks]))
        decoded = [f.result() for f in futs]
        return (np.stack([d[0] for d in decoded]),
                np.asarray([d[1] for d in decoded], np.int32))

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield batches, keeping ``prefetch`` future batches' decode
        work in flight: the next batches decode on the pool while the
        caller's train step occupies the device, and assembly at
        ``next()`` normally just collects already-finished futures."""
        sampler_it = zip(*self.samplers)
        pending: deque = deque()
        # this iterator's OWN in-flight count: two live iterators over one
        # loader must each rewind only their own undelivered batches
        mine = 0

        def submit_next() -> bool:
            nonlocal mine
            # sampler advance + marker + in-flight increment are ONE
            # atomic section against consumed_samples reads from the
            # trainer thread (the transfer thread runs this generator)
            with self._count_lock:
                per_rank = next(sampler_it, None)
                if per_rank is None:
                    return False
                # sampler position *after* drawing this batch — the seed
                # the synchronous (prefetch=0) loader would have used
                marker = self.samplers[0].consumed_samples
                self._inflight += 1
            indices = [i for rank_ids in per_rank for i in rank_ids]
            pending.append(self._submit_batch(indices, marker))
            mine += 1
            return True

        try:
            while True:
                # top up to prefetch batches beyond the one about to be
                # assembled; prefetch=0 degenerates to the synchronous
                # decode-at-next() behavior
                while len(pending) < self.prefetch + 1:
                    if not submit_next():
                        break
                if not pending:
                    break
                x, y = self._assemble(pending.popleft())
                mine -= 1
                with self._count_lock:
                    self._inflight -= 1
                yield x, y
        finally:
            # abandoned iterator (break / exception): the undelivered
            # batches will never be yielded — rewind the samplers so
            # consumed_samples and a fresh __iter__ restart from the
            # first undelivered batch.
            for f in (f for futs in pending for f in futs):
                f.cancel()
            if mine:
                with self._count_lock:
                    for s in self.samplers:
                        s.consumed_samples -= (
                            mine * self.local_batch * self.dp)
                    self._inflight -= mine


def synthetic_image_batches(batch_size: int, image_size: int,
                            num_classes: int, seed: int = 0
                            ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Shape-compatible synthetic stream (uint8, like the real loader) —
    the CI path and the ``--data``-less default of the examples."""
    rng = np.random.RandomState(seed)
    while True:
        x = rng.randint(0, 256, size=(batch_size, image_size, image_size, 3),
                        dtype=np.uint8)
        y = rng.randint(0, num_classes, size=(batch_size,)).astype(np.int32)
        yield x, y
