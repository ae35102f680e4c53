"""ImageNet ResNet training — the port of the repository's
``examples/imagenet_amp.py`` (the analog of the reference's
``examples/imagenet/main_amp.py``).

The same flags over one eager train step on the card::

    # synthetic data:
    python -m apex_tpu_torch.examples.imagenet_amp --arch resnet50 \\
        --opt-level O2 --optimizer sgd --batch-size 128 --steps 100

    # JPEG files (a directory of class subfolders, e.g. ImageNet train/),
    # packed once into a decode-free shard at PREFIX, then trained from it:
    python -m apex_tpu_torch.examples.imagenet_amp --data DIR \\
        --packed PREFIX --opt-level O2 --batch-size 128 --steps 500

Input pipeline (:mod:`apex_tpu_torch.data`): with ``--data`` alone, the
online decode (:class:`~apex_tpu_torch.data.ImageFolderLoader`, native
libjpeg or PIL, thread or process workers) and :func:`~apex_tpu_torch.
data.normalize_on_device` on the card; with ``--packed``, the packed
shard (:class:`~apex_tpu_torch.data.PackedLoader`) and the random crop,
flip and normalize on the card inside the step (:func:`~apex_tpu_torch.
data.packed.random_crop_flip`, drawn from a ``torch.Generator`` on the
card).  Either way the uint8 batches cross to the card through
:func:`~apex_tpu_torch.data.prefetch_to_device` (pinned copies on a side
stream, two batches ahead), and the NHWC output's ``permute(0, 3, 1,
2)`` is the model's channels-last input.

The model is :mod:`apex_tpu_torch.models.resnet` under the amp policy of
``--opt-level`` (:func:`apex_tpu_torch.amp.policy`), trained by
``FusedSGD`` or ``FusedLAMB``; ``--sync-bn`` synchronizes the BN
statistics over the data-parallel ranks when a rank grid is set up (at
one process it is the local BN).  :func:`main` returns the images/s of
the timed steps (all but the first).  Runs on the card unless
``--device cpu``.  torch is imported inside :func:`main`, so the spawned
decode workers of ``--backend process`` start without it.
"""

from __future__ import annotations

import argparse
import os
import time

ARCHS = ("resnet18", "resnet50", "resnet101")


def _check_num_classes(classes, args):
    """Labels >= num_classes would index past the logits — reject up
    front."""
    if len(classes) > args.num_classes:
        raise SystemExit(
            f"dataset has {len(classes)} classes > --num-classes "
            f"{args.num_classes}")


def _split_dir(root, split):
    """The reference's layout: ``root/train`` + ``root/val``.  A flat
    class-dir root (no ``train/`` AND no ``val/``) is used as-is for both
    splits; a *partial* layout (one split dir present, the other
    missing) is an error."""
    have = {s: os.path.isdir(os.path.join(root, s))
            for s in ("train", "val")}
    if not any(have.values()):
        return root  # flat layout
    if not have[split]:
        raise SystemExit(
            f"--data {root!r} has a {'train' if have['train'] else 'val'}/ "
            f"subdirectory but no {split}/ — partial split layouts are "
            "ambiguous (reference layout: root/train + root/val)")
    return os.path.join(root, split)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data", default=None, metavar="DIR",
                   help="ImageFolder root (class subdirectories); "
                        "synthetic data when omitted")
    p.add_argument("--arch", default="resnet50", choices=ARCHS)
    p.add_argument("--opt-level", default="O2",
                   choices=["O0", "O1", "O2", "O3"])
    p.add_argument("--optimizer", default="sgd", choices=["sgd", "lamb"])
    p.add_argument("--sync-bn", action="store_true")
    p.add_argument("--batch-size", type=int, default=64,
                   help="global batch (all dp shards)")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--backend", default="thread",
                   choices=["thread", "process"],
                   help="decode worker backend for the --data (JPEG) "
                        "path: 'process' (spawned workers, no GIL) or "
                        "'thread'")
    p.add_argument("--packed", default=None, metavar="PREFIX",
                   help="train from a packed (decode-free) shard at "
                        "PREFIX; a missing shard with --data is packed "
                        "there first.  The random crop/flip then runs on "
                        "the card inside the step.")
    p.add_argument("--evaluate", action="store_true",
                   help="run a validation pass (top-1/top-5) after "
                        "training; requires --data or --packed")
    p.add_argument("--device", default=None,
                   help="the device to train on (default: the CUDA "
                        "device)")
    args = p.parse_args(argv)
    if args.evaluate and args.data is None and args.packed is None:
        p.error("--evaluate requires --data or --packed")
    return args


def _packed_train_shard(args):
    from apex_tpu_torch.data import PackedImageDataset, pack_image_folder

    if os.path.exists(args.packed + ".json"):
        return PackedImageDataset(args.packed)
    if args.data is None:
        raise SystemExit(f"--packed {args.packed}: shard not found and no "
                         "--data folder to pack it from")
    # records slightly larger than the train crop, so the on-device random
    # crop keeps translation augmentation (232 for the 224 recipe)
    side = (args.image_size + 8 if args.image_size < 224
            else max(232, args.image_size + 8))
    print(f"packing {args.data} -> {args.packed} (one-time, side={side})")
    return pack_image_folder(_split_dir(args.data, "train"), args.packed,
                             side=side, workers=args.workers)


def _packed_val_shard(args):
    """Load (or pack, one-time) the eval shard at ``<packed>_val``, packed
    at side == --image-size with the reference's proportional pre-resize,
    so its pixels are the online eval transform's."""
    from apex_tpu_torch.data import PackedImageDataset, pack_image_folder

    vprefix = args.packed + "_val"
    if os.path.exists(vprefix + ".json"):
        pds_val = PackedImageDataset(vprefix)
    else:
        if args.data is None:
            raise SystemExit(
                f"--evaluate with --packed: val shard {vprefix} not "
                "found and no --data folder to pack it from")
        print(f"packing val split -> {vprefix} (one-time)")
        pds_val = pack_image_folder(_split_dir(args.data, "val"), vprefix,
                                    side=args.image_size,
                                    workers=args.workers)
    if pds_val.side < args.image_size:
        raise SystemExit(f"val shard side={pds_val.side} < --image-size "
                         f"{args.image_size}; re-pack it")
    _check_num_classes(pds_val.classes, args)
    return pds_val


def build(args):
    """The model (channels-last, cast by the amp policy), the optimizer,
    the policy and the data-parallel size."""
    import torch

    from apex_tpu_torch import amp
    from apex_tpu_torch.models import ResNet18, ResNet50, ResNet101
    from apex_tpu_torch.optimizers import FusedLAMB, FusedSGD
    from apex_tpu_torch.parallel import DistributedDataParallel
    from apex_tpu_torch.parallel import mesh as mesh_lib
    from apex_tpu_torch.testing.l1 import apply_policy

    arch = {"resnet18": ResNet18, "resnet50": ResNet50,
            "resnet101": ResNet101}[args.arch]
    policy = amp.policy(args.opt_level)
    grid = mesh_lib.model_parallel_is_initialized()
    sync = args.sync_bn and grid
    model = arch(num_classes=args.num_classes,
                 axis_name="dp" if sync else None,
                 dtype=policy.compute_dtype, device=args.device)
    apply_policy(model, policy)
    model.to(memory_format=torch.channels_last)
    ddp = DistributedDataParallel(model) if grid else None
    params = list(model.parameters())
    if args.optimizer == "sgd":
        opt = FusedSGD(params, lr=args.lr, momentum=0.9, weight_decay=1e-4,
                       master_weights=policy.master_weights)
    else:
        opt = FusedLAMB(params, lr=args.lr, weight_decay=1e-4,
                        master_weights=policy.master_weights)
    dp = mesh_lib.get_data_parallel_world_size() if grid else 1
    return model, ddp, opt, policy, dp


class Recipe:
    """The recipe's training state, a step at a time: the model, the
    optimizer, the loader and its prefetcher (built from ``argv``, the
    command line's flags).  ``step()`` pulls the next batch (re-wrapping
    the prefetcher at each epoch's end) and trains on it, returning the
    loss on the device; ``close()`` releases the loader's workers."""

    def __init__(self, argv=None):
        import torch

        from apex_tpu_torch._device import resolve_device
        from apex_tpu_torch.data import (
            ImageFolder,
            ImageFolderLoader,
            PackedLoader,
            synthetic_image_batches,
        )

        args = self.args = parse_args(argv)
        args.device = resolve_device(args.device)
        if args.evaluate and args.data is not None:
            _split_dir(args.data, "val")  # fail fast on partial layouts
        if args.evaluate and args.packed is not None:
            _packed_val_shard(args)   # pack/validate now, not after training
        self.model, self.ddp, self.opt, self.policy, dp = build(args)
        if args.batch_size % dp != 0:
            raise SystemExit(
                f"--batch-size {args.batch_size} must be divisible by the "
                f"data-parallel world size ({dp})")
        self.loader = None
        if args.packed is not None:
            pds = _packed_train_shard(args)
            if pds.side < args.image_size:
                raise SystemExit(
                    f"--packed shard stores side={pds.side} < --image-size "
                    f"{args.image_size}; re-pack with a larger side")
            _check_num_classes(pds.classes, args)
            print(f"Packed shard: {len(pds)} samples at side {pds.side}, "
                  f"{len(pds.classes)} classes, dp={dp}")
            self.loader = PackedLoader(
                pds, local_batch=args.batch_size // dp,
                data_parallel_size=dp)
        elif args.data is not None:
            dataset = ImageFolder(_split_dir(args.data, "train"))
            _check_num_classes(dataset.classes, args)
            print(f"ImageFolder: {len(dataset)} samples, "
                  f"{len(dataset.classes)} classes, dp={dp}, "
                  f"backend={args.backend}")
            self.loader = ImageFolderLoader(
                dataset, local_batch=args.batch_size // dp,
                data_parallel_size=dp, image_size=args.image_size,
                workers=args.workers, backend=args.backend)
        else:
            self.loader = synthetic_image_batches(
                args.batch_size, args.image_size, args.num_classes)
        self._dev_it = self._wrap()
        # the packed path's crop offsets and flips, drawn on the device
        self.aug = torch.Generator(device=args.device)
        self.aug.manual_seed(17)

    def _wrap(self):
        # the prefetcher is one epoch like the loader: on epoch end it is
        # re-wrapped (close(close_source=False) keeps the decode pool)
        from apex_tpu_torch.data import prefetch_to_device

        return prefetch_to_device(self.loader, depth=2,
                                  device=self.args.device)

    def next_batch(self):
        while True:
            try:
                return next(self._dev_it)
            except StopIteration:  # epoch end: next epoch's permutation
                self._dev_it.close(close_source=False)
                self._dev_it = self._wrap()

    def step(self):
        """One training step on the next batch; the loss (on the
        device)."""
        import torch

        from apex_tpu_torch.data import normalize_on_device
        from apex_tpu_torch.data.packed import random_crop_flip

        args, policy = self.args, self.policy
        x_u8, y = self.next_batch()
        if args.packed is not None:
            # packed records are stored at side > image_size: the train
            # crop, flip and normalize all happen here, on the device
            x = random_crop_flip(x_u8, self.aug, args.image_size,
                                 dtype=policy.compute_dtype)
        else:
            x = normalize_on_device(x_u8, dtype=policy.compute_dtype)
        self.model.train()
        self.opt.zero_grad(set_to_none=True)
        logits = (self.ddp or self.model)(x.permute(0, 3, 1, 2))
        logp = torch.log_softmax(logits.float(), dim=-1)
        y = y.long()
        loss = -logp[torch.arange(y.shape[0], device=y.device), y].mean()
        loss.backward()
        if self.ddp is not None:
            self.ddp.reduce_gradients()
        self.opt.step()
        return loss.detach()

    def sync(self):
        import torch

        if self.args.device.type == "cuda":
            torch.cuda.synchronize(self.args.device)

    def close(self):
        """Stop the prefetcher and, through it, the loader's workers."""
        self._dev_it.close()


def main(argv=None) -> float:
    """Train ``--steps`` steps; returns the images/s of all but the
    first."""
    from apex_tpu_torch.observability import default_registry

    recipe = Recipe(argv)
    args = recipe.args
    t0 = time.perf_counter()
    try:
        for i in range(args.steps):
            loss = recipe.step()
            if i == 0:
                recipe.sync()
                t0 = time.perf_counter()  # exclude the first step
            if i % 10 == 0 or i == args.steps - 1:
                print(f"step {i:4d} loss {float(loss):.4f}")
        recipe.sync()
    finally:
        recipe.close()  # passthrough reclaims the decode pool too
    dt = time.perf_counter() - t0
    ips = args.batch_size * (args.steps - 1) / dt if args.steps > 1 else 0.0
    print(f"throughput: {ips:.1f} images/sec ({dt:.2f}s for "
          f"{args.steps - 1} steps)")
    hist = default_registry().histogram("span_ms/data/next_wait")
    if hist.count:
        print(f"input stall: mean {hist.mean:.2f} ms/step "
              f"(max {hist.max:.2f} ms over {hist.count} steps)")
    if args.evaluate:
        prec1, preck, k = validate(recipe.model, recipe.policy, args)
        print(f"validation: prec@1 {prec1:.3f}  prec@{k} {preck:.3f}")
    return ips


def validate(model, policy, args):
    """One pass over the eval split: the center-crop transform, running
    BN statistics, top-1/top-5 accuracy (the reference's ``validate()``,
    ``main_amp.py:284-342``), over every sample (the last batch short,
    not dropped).  With ``--packed`` the val shard (``PREFIX_val``) is
    read in order and center-cropped on the card; else the JPEG files
    are decoded by the eval transform."""
    import numpy as np
    import torch

    from apex_tpu_torch.data import (
        ImageFolder,
        center_crop_resize,
        normalize_on_device,
    )
    from apex_tpu_torch.data.packed import center_crop

    k = min(5, args.num_classes)
    if args.packed is not None:
        pds_val = _packed_val_shard(args)
        n_total = len(pds_val)

        def load(start, stop):
            return (np.asarray(pds_val.images[start:stop]),
                    np.asarray(pds_val.labels[start:stop]))
    else:
        dataset = ImageFolder(_split_dir(args.data, "val"))
        n_total = len(dataset)

        def load(start, stop):
            pairs = [dataset.load(i) for i in range(start, stop)]
            return (np.stack([center_crop_resize(img, args.image_size)
                              for img, _ in pairs]),
                    np.asarray([label for _, label in pairs]))

    model.eval()
    c1 = torch.zeros((), dtype=torch.int64, device=args.device)
    c5 = torch.zeros_like(c1)
    with torch.no_grad():
        for start in range(0, n_total, args.batch_size):
            xs, ys = load(start, min(start + args.batch_size, n_total))
            x = torch.from_numpy(np.array(xs)).to(args.device)
            y = torch.from_numpy(ys).long().to(args.device)
            if args.packed is not None:
                x = center_crop(x, args.image_size,
                                dtype=policy.compute_dtype)
            else:
                x = normalize_on_device(x, dtype=policy.compute_dtype)
            logits = model(x.permute(0, 3, 1, 2)).float()
            topk = torch.topk(logits, k, dim=-1).indices
            c1 += (topk[:, 0] == y).sum()
            c5 += (topk == y[:, None]).any(dim=1).sum()
    n = max(n_total, 1)
    return int(c1) / n, int(c5) / n, k


if __name__ == "__main__":
    main()
