"""The port's input pipeline (``apex_tpu_torch.data``, ``testing/
data_resume.py``, ``testing/data_pipeline_smoke.py`` and the ImageNet
recipe ``apex_tpu_torch.examples.imagenet_amp``) against the JAX
package's ``apex_tpu.data``.

The loaders are host code in both packages, so they are held exactly:
the samplers' index streams, every batch byte for byte across ``dp_ranks``
and after a restart from ``consumed_samples``, the shard files byte for
byte with each package reading the other's, the crop boxes and the
decoded bytes (the native libjpeg decoder, built with ``cc`` from the
port's copy of ``jpegdec.c``, and PIL), on one tiny JPEG tree (two
classes of six 40 x 48 images, written from ``RandomState(0)``).  The
augmentation's apply step is held against the reference's arithmetic
(``dynamic_slice``, the flip ``where`` and ``normalize_on_device``) at
1e-6; its draws only by their range (the port draws from a
``torch.Generator``, the reference from ``jax.random``).  The prefetcher
and the data service run on the CPU (``device="cpu"``); the decode
workers and the service are spawned processes.
"""

import functools
import hashlib
import json
import multiprocessing as mp
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch_threads import one_torch_thread  # noqa: F401

from apex_tpu.data import _jpeg_native as j_native
from apex_tpu.data import _producer as j_producer
from apex_tpu.data import image_folder as j_if
from apex_tpu.data import packed as j_packed
from apex_tpu.data import sequence as j_seq
from apex_tpu_torch import data as tdata
from apex_tpu_torch.data import _jpeg_native as t_native
from apex_tpu_torch.data import _producer as t_producer
from apex_tpu_torch.data import image_folder as t_if
from apex_tpu_torch.data import packed as t_packed
from apex_tpu_torch.data import sequence as t_seq
from apex_tpu_torch.observability.metrics import MetricRegistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=REPO)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The tiny JPEG tree, plus a CMYK JPEG and a PNG named ``.jpg`` (both
    decode only through PIL) in a third class."""
    root = tmp_path_factory.mktemp("jpegs")
    rng = np.random.RandomState(0)
    for c in range(2):
        d = root / f"class_{c}"
        d.mkdir()
        for i in range(6):
            arr = rng.randint(0, 256, (40, 48, 3), dtype=np.uint8)
            Image.fromarray(arr).save(d / f"{i}.jpg", quality=90)
    odd = root / "class_2"
    odd.mkdir()
    arr = rng.randint(0, 256, (36, 44, 3), dtype=np.uint8)
    Image.fromarray(arr).convert("CMYK").save(odd / "cmyk.jpg", quality=90)
    Image.fromarray(arr).save(odd / "png.jpg", format="PNG")
    return str(root)


def _same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            u, v = np.asarray(u), np.asarray(v)
            assert u.dtype == v.dtype and u.shape == v.shape
            assert u.tobytes() == v.tobytes()


# ------------------------------------------------------------ the samplers

# (total, local batch, dp, consumed, dp_ranks)
SAMPLERS = [(24, 2, 2, 0, None), (24, 2, 2, 8, (1,)), (30, 3, 2, 50, (0,)),
            (16, 4, 1, 4, None), (20, 2, 4, 0, (3, 1))]


@pytest.mark.parametrize("case", SAMPLERS, ids=str)
def test_make_dp_samplers_index_streams_match_jax(case):
    def stream(mod):
        ranks, samplers = mod.make_dp_samplers(*case)
        steps = zip(*(iter(s) for s in samplers))
        return ranks, [[list(i) for i in step] for _, step in
                       zip(range(5), steps)]

    assert stream(t_producer) == stream(j_producer)


@pytest.mark.parametrize("ranks", [(), (0, 0), (2,)], ids=str)
def test_make_dp_samplers_rejects_what_jax_rejects(ranks):
    for mod in (t_producer, j_producer):
        with pytest.raises(ValueError):
            mod.make_dp_samplers(16, 2, 2, 0, ranks)


# --------------------------------------------------- the sequence shards

@pytest.fixture(scope="module")
def seq_shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("seq")
    docs = t_seq.synthetic_token_documents(40, vocab=64, mean_len=20, seed=3)
    assert docs == j_seq.synthetic_token_documents(40, vocab=64,
                                                   mean_len=20, seed=3)
    t_seq.pack_token_documents(docs, str(root / "port"), seq_len=16,
                               eos_id=63)
    j_seq.pack_token_documents(docs, str(root / "ref"), seq_len=16,
                               eos_id=63)
    return str(root / "port"), str(root / "ref")


def test_sequence_shards_are_the_reference_bytes(seq_shards):
    port, ref = seq_shards
    for suffix in (".tokens", ".segments", ".json"):
        with open(port + suffix, "rb") as a, open(ref + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    for prefix in seq_shards:
        t, j = (t_seq.PackedSequenceDataset(prefix),
                j_seq.PackedSequenceDataset(prefix))
        assert (len(t), t.seq_len, t.n_docs) == (len(j), j.seq_len, j.n_docs)
        np.testing.assert_array_equal(t.tokens, j.tokens)
        np.testing.assert_array_equal(t.segments, j.segments)


def test_pack_token_documents_drop_remainder_and_errors_match_jax(tmp_path):
    docs = [[1, 2, 3], [4, 5, 6, 7, 8]]
    for drop in (False, True):
        t_seq.pack_token_documents(docs, str(tmp_path / f"t{drop}"), 3,
                                   drop_remainder=drop)
        j_seq.pack_token_documents(docs, str(tmp_path / f"j{drop}"), 3,
                                   drop_remainder=drop)
        for suffix in (".tokens", ".segments", ".json"):
            assert (tmp_path / f"t{drop}{suffix}").read_bytes() == \
                (tmp_path / f"j{drop}{suffix}").read_bytes()
    for mod in (t_seq, j_seq):
        with pytest.raises(ValueError):
            mod.pack_token_documents(docs, str(tmp_path / "x"), 1)
        with pytest.raises(ValueError):
            mod.pack_token_documents([[]], str(tmp_path / "y"), 4)


def _epoch(loader_cls, ds, n=None, **kw):
    with loader_cls(ds, **kw) as loader:
        out = []
        for batch in loader:
            out.append(tuple(np.asarray(x) for x in batch))
            if n is not None and len(out) == n:
                break
        return out, loader.consumed_samples


# (local batch, dp, dp_ranks, consumed)
LOADERS = [(2, 1, None, 0), (2, 2, None, 0), (2, 2, (1,), 0),
           (3, 2, (0,), 9), (2, 2, None, 40)]


@pytest.mark.parametrize("case", LOADERS, ids=str)
def test_sequence_loader_batches_match_jax(seq_shards, case):
    """One epoch, then a restart from the port's ``consumed_samples``
    after two batches: the same batches, byte for byte."""
    lb, dp, ranks, consumed = case
    kw = dict(local_batch=lb, data_parallel_size=dp, dp_ranks=ranks,
              consumed_samples=consumed, seed=5)
    t_ds = t_seq.PackedSequenceDataset(seq_shards[0])
    j_ds = j_seq.PackedSequenceDataset(seq_shards[1])
    got, t_end = _epoch(t_seq.PackedSequenceLoader, t_ds, **kw)
    want, j_end = _epoch(j_seq.PackedSequenceLoader, j_ds, **kw)
    _same_batches(got, want)
    assert t_end == j_end
    head, mid = _epoch(t_seq.PackedSequenceLoader, t_ds,
                       n=max(1, len(got) // 2), **kw)
    tail, _ = _epoch(t_seq.PackedSequenceLoader, t_ds,
                     **dict(kw, consumed_samples=mid))
    _same_batches(head + tail, got)


def test_segment_loss_mask_on_numpy_and_torch_matches_jax():
    segs = np.array([[1, 1, 2, 2, 0], [1, 1, 1, 0, 0]], np.int32)
    want = np.asarray(j_seq.segment_loss_mask(jnp.asarray(segs)))
    got = t_seq.segment_loss_mask(segs)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        t_seq.segment_loss_mask(torch.from_numpy(segs)).numpy(), want)


# ------------------------------------------------------ the image shards

@pytest.fixture(scope="module")
def image_shards(tree, tmp_path_factory):
    root = tmp_path_factory.mktemp("packed")
    kw = dict(side=24, workers=2)
    t_packed.pack_image_folder(t_if.ImageFolder(tree), str(root / "port"),
                               **kw)
    j_packed.pack_image_folder(tree, str(root / "ref"), **kw)
    return str(root / "port"), str(root / "ref")


def test_image_shards_are_the_reference_bytes(image_shards):
    port, ref = image_shards
    for suffix in (".data", ".labels.npy", ".json"):
        with open(port + suffix, "rb") as a, open(ref + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    for prefix in image_shards:
        t, j = (t_packed.PackedImageDataset(prefix),
                j_packed.PackedImageDataset(prefix))
        assert (len(t), t.side, t.classes) == (len(j), j.side, j.classes)
        np.testing.assert_array_equal(t.images, j.images)
        np.testing.assert_array_equal(t.labels, j.labels)


@pytest.mark.parametrize("case", LOADERS[:4], ids=str)
def test_packed_loader_batches_match_jax(image_shards, case):
    lb, dp, ranks, consumed = case
    kw = dict(local_batch=lb, data_parallel_size=dp, dp_ranks=ranks,
              consumed_samples=consumed, seed=2)
    t_ds = t_packed.PackedImageDataset(image_shards[0])
    got, t_end = _epoch(t_packed.PackedLoader, t_ds, **kw)
    want, j_end = _epoch(j_packed.PackedLoader,
                         j_packed.PackedImageDataset(image_shards[1]), **kw)
    _same_batches(got, want)
    assert t_end == j_end
    head, mid = _epoch(t_packed.PackedLoader, t_ds, n=1, **kw)
    tail, _ = _epoch(t_packed.PackedLoader, t_ds,
                     **dict(kw, consumed_samples=mid))
    _same_batches(head + tail, got)


# ------------------------------------------------------ crops and decode

@pytest.mark.parametrize("wh", [(48, 40), (300, 120), (64, 64), (10, 90)],
                         ids=str)
def test_crop_boxes_match_jax(wh):
    w, h = wh
    for seed in range(20):
        a = t_if.sample_crop_box(np.random.RandomState(seed), w, h)
        b = j_if.sample_crop_box(np.random.RandomState(seed), w, h)
        assert a == b
    for size, resize in ((16, None), (24, 30), (32, None)):
        assert (t_if.eval_crop_box(w, h, size, resize)
                == j_if.eval_crop_box(w, h, size, resize))


def test_pil_crops_match_jax(tree):
    ds = t_if.ImageFolder(tree)
    assert ds.samples == j_if.ImageFolder(tree).samples
    assert ds.classes == ["class_0", "class_1", "class_2"]
    for i in range(len(ds)):
        img, label = ds.load(i)
        for seed in range(3):
            a = t_if.random_resized_crop(np.random.RandomState(seed), img, 16)
            b = j_if.random_resized_crop(np.random.RandomState(seed), img, 16)
            assert a.tobytes() == b.tobytes()
        assert (t_if.center_crop_resize(img, 16, 20).tobytes()
                == j_if.center_crop_resize(img, 16, 20).tobytes())


def test_native_decoder_matches_jax_and_pil_takes_what_it_refuses(tree):
    """Both packages build their ``jpegdec.c`` with ``cc`` (the port into
    ``build/apex_tpu_torch/``) and decode the same bytes; the CMYK JPEG
    and the PNG named ``.jpg`` are refused by the kernel (``None``) and
    decoded by the loader through PIL."""
    assert t_native.native_available(), t_native.build_error()
    assert t_native.build_error() is None
    so = t_native._library_path()
    assert so.parent.name == "apex_tpu_torch" and so.parent.parent.name \
        == "build" and so.exists()
    ds = t_if.ImageFolder(tree)
    for path, _ in ds.samples:
        data = open(path, "rb").read()
        assert t_native.jpeg_dims(data) == j_native.jpeg_dims(data)
        if "class_2" in path:
            assert t_native.decode_crop_resize(data, 0, 0, 30, 30, 16,
                                               16) is None
            continue
        for box, flip in (((0, 0, 40, 48), False), ((5, 7, 20, 30), True)):
            a = t_native.decode_crop_resize(data, *box, 16, 16, flip)
            b = j_native.decode_crop_resize(data, *box, 16, 16, flip)
            assert a is not None and a.tobytes() == b.tobytes()
    spec = t_if._DecodeSpec(dataset=ds, image_size=16, train=True, seed=3,
                            native=True)
    jspec = j_if._DecodeSpec(dataset=j_if.ImageFolder(tree), image_size=16,
                             train=True, seed=3, native=True)
    for i in range(len(ds)):
        a, la = t_if._decode_one(spec, i, 5)
        b, lb = j_if._decode_one(jspec, i, 5)
        assert la == lb and a.tobytes() == b.tobytes()
    odd = [i for i, (p, _) in enumerate(ds.samples) if "class_2" in p]
    for i in odd:
        assert t_if._decode_native_one(spec, i, np.random.RandomState(0)) \
            is None
        pil = t_if._DecodeSpec(*spec[:4], native=False)
        assert (t_if._decode_one(spec, i, 5)[0].tobytes()
                == t_if._decode_one(pil, i, 5)[0].tobytes())


@pytest.mark.parametrize("backend", ["thread", "process"])
def test_image_folder_loader_matches_jax(tree, backend):
    """Both backends, two dp ranks, one epoch and a restart: the JAX
    package's thread-backend batches, byte for byte (train and eval
    transforms)."""
    ds = t_if.ImageFolder(tree)
    jds = j_if.ImageFolder(tree)
    for train in (True, False):
        kw = dict(local_batch=2, data_parallel_size=2, image_size=16,
                  workers=2, seed=4, train=train)
        got, end = _epoch(t_if.ImageFolderLoader, ds, backend=backend, **kw)
        want, jend = _epoch(j_if.ImageFolderLoader, jds, backend="thread",
                            **kw)
        _same_batches(got, want)
        assert end == jend
    head, mid = _epoch(t_if.ImageFolderLoader, ds, n=1, backend=backend,
                       **kw)
    tail, _ = _epoch(t_if.ImageFolderLoader, ds, backend=backend,
                     **dict(kw, consumed_samples=mid))
    _same_batches(head + tail, got)
    assert not mp.active_children()


def test_the_data_package_and_its_decode_workers_import_no_torch(tree):
    """``import apex_tpu_torch.data`` pulls in no torch, and a spawned
    decode worker of the process backend has none loaded after decoding
    a chunk."""
    code = ("import sys, apex_tpu_torch.data, apex_tpu_torch.data."
            "_jpeg_native; print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], env=ENV, check=True,
                         capture_output=True, text=True, cwd=REPO)
    assert out.stdout.strip() == "False"
    with t_if.ImageFolderLoader(t_if.ImageFolder(tree), local_batch=2,
                                image_size=16, workers=1,
                                backend="process") as loader:
        next(iter(loader))
        seen = loader._pool.submit(
            eval, "'torch' in __import__('sys').modules").result()
    assert seen is False


# ---------------------------------------------------------- augmentation

def _jax_crop_flip(images, off_h, off_w, flip, out):
    """The reference's ``random_crop_flip`` body at given draws."""
    def one(img, oh, ow, fl):
        crop = jax.lax.dynamic_slice(img, (oh, ow, 0), (out, out, 3))
        return jnp.where(fl, crop[:, ::-1, :], crop)

    cropped = jax.vmap(one)(jnp.asarray(images), jnp.asarray(off_h),
                            jnp.asarray(off_w), jnp.asarray(flip))
    return np.asarray(jax.jit(j_if.normalize_on_device)(cropped))


def test_apply_crop_flip_matches_the_reference_arithmetic():
    rng = np.random.RandomState(1)
    images = rng.randint(0, 256, (6, 12, 12, 3), dtype=np.uint8)
    off_h = rng.randint(0, 5, 6)
    off_w = rng.randint(0, 5, 6)
    flip = np.array([0, 1, 1, 0, 1, 0], bool)
    got = t_packed.apply_crop_flip(
        torch.from_numpy(images), torch.from_numpy(off_h),
        torch.from_numpy(off_w), torch.from_numpy(flip), 8)
    want = _jax_crop_flip(images, off_h, off_w, flip, 8)
    assert got.shape == (6, 8, 8, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # the eval transform
    np.testing.assert_allclose(
        t_packed.center_crop(torch.from_numpy(images), 8).numpy(),
        np.asarray(j_packed.center_crop(jnp.asarray(images), 8)),
        rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        t_packed.random_crop_flip(torch.from_numpy(images),
                                  torch.Generator(), 13)


def test_random_crop_flip_draws_stay_in_range_with_both_flips():
    gen = torch.Generator().manual_seed(0)
    off_h, off_w, flip = t_packed.draw_crop_flip(512, 8, gen)
    for off in (off_h, off_w):
        assert off.min() == 0 and off.max() == 8
        assert len(torch.unique(off)) == 9
    assert 0.4 < flip.float().mean() < 0.6
    images = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, (4, 10, 10, 3), dtype=np.uint8))
    x = t_packed.random_crop_flip(images, torch.Generator().manual_seed(3),
                                  6, dtype=torch.bfloat16)
    assert x.shape == (4, 6, 6, 3) and x.dtype == torch.bfloat16
    y = t_packed.random_crop_flip(images, torch.Generator().manual_seed(3),
                                  6, dtype=torch.bfloat16)
    assert torch.equal(x, y)


# ------------------------------------------------- prefetch and service

class _Loader:
    """A loader-shaped source: ``local_batch``/``dp``/``consumed_samples``
    and ``rewind_batches`` over a list of items."""

    def __init__(self, items, per=2):
        self.items, self.local_batch, self.dp = items, per, 1
        self.consumed_samples = 0
        self.closed = False

    def __iter__(self):
        for x in self.items:
            if isinstance(x, Exception):
                raise x
            self.consumed_samples += self.local_batch
            yield x

    def rewind_batches(self, n):
        self.consumed_samples -= n * self.local_batch

    def close(self):
        self.closed = True


@pytest.mark.parametrize("depth", [0, 2])
def test_prefetch_order_none_items_and_resume_count(depth):
    items = [(np.full((2, 3), i, np.int32),) for i in range(5)]
    items[2] = None
    src = _Loader(items)
    reg = MetricRegistry(rank=0, world=1)
    dev = tdata.prefetch_to_device(src, depth=depth, device="cpu",
                                   registry=reg)
    got = []
    for _ in range(3):
        got.append(next(dev))
    assert got[2] is None
    assert [int(b[0][0, 0]) for b in got[:2]] == [0, 1]
    assert isinstance(got[0][0], torch.Tensor)
    assert dev.consumed_samples == 6
    dev.close()
    assert src.closed and src.consumed_samples == 6
    if depth:
        assert reg.histogram("span_ms/data/next_wait").count == 3
        assert reg.snapshot()["data/stall_ms"] >= 0
    rest = list(tdata.prefetch_to_device(items[3:], depth=depth,
                                         device="cpu"))
    assert [int(b[0][0, 0]) for b in rest] == [3, 4]


def test_prefetch_relays_errors_and_enforces_its_composition():
    dev = tdata.prefetch_to_device(
        _Loader([(np.zeros(1),), ValueError("bad gather")]), device="cpu")
    next(dev)
    with pytest.raises(ValueError, match="bad gather"):
        next(dev)
    with pytest.raises(StopIteration):
        next(dev)
    with pytest.raises(TypeError, match="nested"):
        tdata.prefetch_to_device(dev)
    plain = tdata.prefetch_to_device(iter([1, 2]), device="cpu")
    with pytest.raises(AttributeError, match="loader"):
        plain.consumed_samples  # noqa: B018
    plain.close()


def test_prefetch_over_a_loader_rewinds_undelivered_batches(seq_shards):
    ds = t_seq.PackedSequenceDataset(seq_shards[0])
    loader = t_seq.PackedSequenceLoader(ds, local_batch=2, prefetch=2)
    dev = tdata.prefetch_to_device(loader, depth=2, device="cpu")
    first = [next(dev) for _ in range(3)]
    assert dev.consumed_samples == 6
    dev.close()
    assert loader.consumed_samples == 6
    again = t_seq.PackedSequenceLoader(ds, local_batch=2,
                                       consumed_samples=6)
    want = [b for _, b in zip(range(6), again)]
    full = [b for _, b in zip(range(6), t_seq.PackedSequenceLoader(
        ds, local_batch=2))]
    _same_batches([tuple(t.numpy() for t in b) for b in first],
                  full[:3])
    _same_batches(want[:3], full[3:6])


def test_data_service_round_trip_shuts_down_clean(seq_shards):
    from apex_tpu_torch.testing.data_pipeline_smoke import _service_factory

    want = [b for _, b in zip(range(4), t_seq.PackedSequenceLoader(
        t_seq.PackedSequenceDataset(seq_shards[0]), local_batch=4,
        consumed_samples=8))]
    svc = tdata.DataService(functools.partial(_service_factory,
                                              seq_shards[0]),
                            consumed_samples=8)
    assert (svc.local_batch, svc.dp, svc.consumed_samples) == (4, 1, 8)
    dev = tdata.prefetch_to_device(svc, depth=2, device="cpu")
    got = [tuple(t.numpy() for t in next(dev)) for _ in range(4)]
    _same_batches(got, want)
    assert dev.consumed_samples == 8 + 16
    dev.close()
    assert not svc._proc.is_alive() and not mp.active_children()


def test_data_pipeline_smoke_runs_clean(tmp_path):
    """``testing/data_pipeline_smoke.py``: the double-buffered stall under
    the synchronous pull, and no child process left after ``close()``."""
    from apex_tpu_torch.testing import data_pipeline_smoke

    assert data_pipeline_smoke.main(str(tmp_path)) == 0
    assert not mp.active_children()


# ------------------------------------------------- resume and the recipe

FAMILIES = ("sequence", "image")


def _resume_argv(family, phase, work, stream):
    return ["--family", family, "--work", str(work), "--phase", phase,
            "--stream", str(stream), "--device", "cpu"]


@pytest.mark.parametrize("family", FAMILIES)
def test_data_resume_after_sigkill_matches_the_uninterrupted_stream(
        tmp_path, family):
    """``testing/data_resume.py``: run, SIGKILLed after 5 of 13 batches
    mid-epoch (a child process), resumed from the ``CheckpointManager``'s
    counter; its stream of batch hashes is the uninterrupted run's (the
    reference and resume phases run in this process)."""
    from apex_tpu_torch.testing import data_resume

    root = tmp_path
    proc = subprocess.Popen(
        [sys.executable, "-m", "apex_tpu_torch.testing.data_resume",
         *_resume_argv(family, "run", root / "b", root / "run.txt")],
        env=ENV, cwd=REPO, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    try:
        _, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == -9, err[-2000:]
    killed = (root / "run.txt").read_text().splitlines()
    assert 5 <= len(killed) < 13
    assert data_resume.main(_resume_argv(family, "resume", root / "b",
                                         root / "run.txt")) == 0
    assert data_resume.main(_resume_argv(family, "ref", root / "a",
                                         root / "ref.txt")) == 0
    ref = (root / "ref.txt").read_text()
    assert ref.count("\n") == 13
    assert (root / "run.txt").read_text() == ref


def test_imagenet_recipe_trains_from_a_packed_shard_and_evaluates(
        tree, tmp_path):
    """The recipe on the CPU at a tiny size: the JPEG tree packed, two
    steps of ResNet-18 at 16 x 16 from the packed shard (O2, FusedSGD),
    finite images/s, and the evaluation over the packed val shard; then
    the online decode path with process workers."""
    from apex_tpu_torch.examples import imagenet_amp

    common = ["--arch", "resnet18", "--image-size", "16", "--batch-size",
              "4", "--steps", "2", "--num-classes", "4", "--device", "cpu",
              "--workers", "2"]
    ips = imagenet_amp.main(["--data", tree, "--packed",
                             str(tmp_path / "shard"), "--evaluate"] + common)
    assert np.isfinite(ips) and ips > 0
    meta = json.loads((tmp_path / "shard.json").read_text())
    assert meta["side"] == 24 and meta["n"] == 14
    assert (tmp_path / "shard_val.json").exists()
    ips = imagenet_amp.main(["--data", tree, "--backend", "process",
                             "--optimizer", "lamb"] + common)
    assert np.isfinite(ips) and ips > 0
    assert not mp.active_children()


def test_batch_digest_is_the_reference_digest():
    from apex_tpu.testing import data_resume as j_resume
    from apex_tpu_torch.testing import data_resume as t_resume

    batch = (np.arange(6, dtype=np.int32).reshape(2, 3),
             np.ones(2, np.uint8))
    assert t_resume._batch_digest(batch) == j_resume._batch_digest(batch)
    h = hashlib.sha256()
    for leaf in batch:
        h.update(leaf.tobytes())
    assert t_resume._batch_digest(batch) == h.hexdigest()
