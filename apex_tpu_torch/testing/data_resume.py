"""Mid-epoch kill/resume proof for the input pipeline (port of
:mod:`apex_tpu.testing.data_resume`).

The loaders claim *exact* mid-epoch resume: checkpoint the device
prefetcher's ``consumed_samples`` through
:class:`apex_tpu_torch.resilience.CheckpointManager`, SIGKILL the process at
any instant, rebuild loader + wrapper from the restored counter, and the
delivered sample stream continues with **no skipped and no duplicated
samples** — for both loader families (the online-decode
``ImageFolderLoader`` and the decode-free packed loaders, here the LM
``PackedSequenceLoader``).  Claims proven by inspection rot; this module
is the script ``tests/test_torch_data.py`` and ``chip_smoke.py`` drive
end to end (on the card unless ``--device cpu``):

- ``--phase run``     — stream batches through
  ``loader -> prefetch_to_device``, append each delivered batch's
  sha256 (of its raw bytes) + its post-delivery ``consumed_samples`` to
  ``--stream`` (fsynced per line, the crash_resume.py discipline), save
  ``{"consumed_samples": n}`` via ``CheckpointManager`` after every
  batch, and **SIGKILL ourselves** after ``--kill-after`` batches —
  deliberately mid-epoch (the harness sizes the epoch so the kill never
  lands on an epoch boundary).
- ``--phase resume``  — ``restore_latest`` the counter, truncate the
  stream file to batches the checkpoint covers (a crash may have logged
  a batch newer than the last durable save — exactly crash_resume.py's
  ``_truncate_losses``), rebuild loader + wrapper from it, and stream
  the remaining batches.
- ``--phase ref``     — the uninterrupted reference: same dataset, same
  total batches, no kill.

The caller compares the killed+resumed stream file to the reference's
byte-for-byte: equality holds only if resume replayed exactly the
undelivered batches (a skip or a duplicate shifts every subsequent
hash).
"""

from __future__ import annotations

import argparse
import hashlib
import os
import signal
import sys

if __name__ == "__main__":  # runnable as a plain script path
    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))))


def _append(path: str, consumed: int, digest: str) -> None:
    with open(path, "a") as f:
        f.write(f"{consumed} {digest}\n")
        f.flush()
        os.fsync(f.fileno())


def _truncate(path: str, consumed: int) -> None:
    """Drop stream lines newer than the restored checkpoint."""
    if not os.path.exists(path):
        return
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines()
                 if ln and int(ln.split()[0]) <= consumed]
    with open(path, "w") as f:
        f.write("".join(ln + "\n" for ln in lines))
        f.flush()
        os.fsync(f.fileno())


def _batch_digest(batch) -> str:
    h = hashlib.sha256()
    import numpy as np

    for leaf in batch:
        h.update(np.asarray(leaf).tobytes())
    return h.hexdigest()


def _make_image_dataset(root: str):
    """Deterministic tiny JPEG tree (created once per work dir)."""
    import numpy as np
    from PIL import Image

    from apex_tpu_torch.data import ImageFolder

    marker = os.path.join(root, ".complete")
    if not os.path.exists(marker):
        rng = np.random.RandomState(0)
        for c in range(2):
            d = os.path.join(root, f"class_{c}")
            os.makedirs(d, exist_ok=True)
            for i in range(24):
                arr = rng.randint(0, 256, (48, 56, 3), dtype=np.uint8)
                Image.fromarray(arr).save(os.path.join(d, f"{i}.jpg"),
                                          quality=92)
        with open(marker, "w") as f:
            f.write("ok")
    return ImageFolder(root)


def _make_sequence_dataset(prefix: str):
    from apex_tpu_torch.data import (
        PackedSequenceDataset,
        pack_token_documents,
        synthetic_token_documents,
    )

    if not os.path.exists(prefix + ".json"):
        docs = synthetic_token_documents(64, vocab=64, mean_len=24, seed=3)
        return pack_token_documents(docs, prefix, seq_len=32, eos_id=63)
    return PackedSequenceDataset(prefix)


def _make_loader(family: str, work: str, consumed: int):
    if family == "image":
        ds = _make_image_dataset(os.path.join(work, "jpegs"))
        from apex_tpu_torch.data import ImageFolderLoader

        return ImageFolderLoader(ds, local_batch=2, data_parallel_size=2,
                                 image_size=16, seed=7, prefetch=2,
                                 consumed_samples=consumed)
    if family == "sequence":
        ds = _make_sequence_dataset(os.path.join(work, "seq", "train"))
        from apex_tpu_torch.data import PackedSequenceLoader

        return PackedSequenceLoader(ds, local_batch=2,
                                    data_parallel_size=2, seed=7,
                                    prefetch=2, consumed_samples=consumed)
    raise ValueError(f"unknown family {family!r}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--family", choices=["image", "sequence"], required=True)
    p.add_argument("--work", required=True)
    p.add_argument("--phase", choices=["run", "resume", "ref"],
                   required=True)
    p.add_argument("--stream", required=True,
                   help="delivered-batch hash log (append)")
    p.add_argument("--total-batches", type=int, default=13,
                   help="batches the full (ref / killed+resumed) stream "
                        "delivers; deliberately NOT a multiple of the "
                        "batches-per-epoch so the run crosses an epoch "
                        "boundary mid-stream")
    p.add_argument("--kill-after", type=int, default=5,
                   help="run phase: deliver this many batches, then "
                        "SIGKILL ourselves (mid-epoch)")
    p.add_argument("--device", default=None,
                   help="where the prefetcher places the batches "
                        "(default: the CUDA device)")
    args = p.parse_args(argv)

    import torch

    from apex_tpu_torch.data import prefetch_to_device
    from apex_tpu_torch.resilience import CheckpointManager

    os.makedirs(args.work, exist_ok=True)
    ckpt_dir = os.path.join(args.work, f"ckpt_{args.family}")
    mgr = CheckpointManager(ckpt_dir, keep=2)

    consumed = 0
    if args.phase == "resume":
        tree, _ = mgr.restore_latest(
            {"consumed_samples": torch.zeros((), dtype=torch.int64)})
        consumed = int(tree["consumed_samples"])
        _truncate(args.stream, consumed)

    loader = _make_loader(args.family, args.work, consumed)
    per_batch = loader.local_batch * loader.dp
    done = consumed // per_batch  # batches already on the stream log

    # the device wrapper: the default placement (pinned copies on a side
    # stream on the card, no mesh) — the H2D hop is part of the pipeline
    # under test
    dev = prefetch_to_device(loader, depth=2, device=args.device)
    # the wrapper is per-epoch like the loaders: re-wrap on exhaustion
    step = done
    try:
        while step < args.total_batches:
            try:
                batch = next(dev)
            except StopIteration:
                dev.close(close_source=False)  # keep the decode pool
                dev = prefetch_to_device(loader, depth=2,
                                         device=args.device)
                continue
            host = tuple(x.cpu().numpy() for x in batch)
            _append(args.stream, dev.consumed_samples, _batch_digest(host))
            mgr.save({"consumed_samples": torch.tensor(
                dev.consumed_samples, dtype=torch.int64)}, step)
            step += 1
            if args.phase == "run" and step - done >= args.kill_after:
                # the mid-epoch SIGKILL: no cleanup, no atexit — the
                # process dies with decode futures and device transfers
                # in flight
                print(f"data_resume: SIGKILL after {step} batches",
                      file=sys.stderr, flush=True)
                os.kill(os.getpid(), signal.SIGKILL)
    finally:
        dev.close()
    print(f"data_resume: {args.phase} done, {step} batches, "
          f"consumed={loader.consumed_samples}", file=sys.stderr,
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
