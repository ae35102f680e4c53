"""Input-pipeline smoke: every layer of apex_tpu_torch.data, end to end
(port of :mod:`apex_tpu.testing.data_pipeline_smoke`).

Run as ``python -m apex_tpu_torch.testing.data_pipeline_smoke [WORK_DIR]``
(``tests/test_torch_data.py`` runs it on the CPU): builds a small synthetic JPEG tree
and a packed LM token stream, pushes both through the production stack —
process-pool decode, ``DataService`` loader process, double-buffered
``prefetch_to_device`` — and asserts the two properties a smoke can
prove cheaply:

- **nonzero overlap**: a paced consumer's steady-state stall through the
  double-buffered prefetcher is well under the synchronous (depth=0)
  pull time on the same loader — decode/transfer really do hide under
  the consumer's step;
- **clean shutdown**: after ``close()``, no loader worker processes and
  no service process survive (``multiprocessing.active_children()``
  empty), and the process exits 0 without leaked threads wedging
  interpreter teardown.
"""

from __future__ import annotations

import os
import statistics
import sys
import time

if __name__ == "__main__":  # runnable as a plain script path
    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))))


def _build_jpeg_tree(root: str, n_classes: int = 2, per_class: int = 48,
                     side: int = 224) -> None:
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(0)
    for c in range(n_classes):
        d = os.path.join(root, f"class_{c}")
        os.makedirs(d, exist_ok=True)
        for i in range(per_class):
            arr = rng.randint(0, 256, (side, side, 3), dtype=np.uint8)
            Image.fromarray(arr).save(os.path.join(d, f"{i}.jpg"),
                                      quality=90)


def _service_factory(prefix: str, consumed: int):
    """Module-level (picklable) DataService factory for the LM stream."""
    from apex_tpu_torch.data import PackedSequenceDataset, PackedSequenceLoader

    return PackedSequenceLoader(PackedSequenceDataset(prefix),
                                local_batch=4, consumed_samples=consumed)


def main(work: str) -> int:
    import multiprocessing as mp

    import numpy as np

    from apex_tpu_torch.data import (
        DataService,
        ImageFolder,
        ImageFolderLoader,
        pack_token_documents,
        prefetch_to_device,
        segment_loss_mask,
        synthetic_token_documents,
    )
    from apex_tpu_torch.observability.metrics import MetricRegistry

    os.makedirs(work, exist_ok=True)
    jpeg_root = os.path.join(work, "jpegs")
    _build_jpeg_tree(jpeg_root)
    ds = ImageFolder(jpeg_root)

    # --- image leg: process-pool decode + double-buffered prefetch -----
    def stall_at(depth: int) -> float:
        # 2 workers on a 16-image 224px batch: several ms of real decode
        # per batch, so the overlap assertion has margin over timer
        # jitter (a paced consumer hides it entirely at depth 2; a
        # synchronous depth-0 pull pays it at next())
        reg = MetricRegistry(rank=0, world=1)
        with ImageFolderLoader(ds, local_batch=16, image_size=128, seed=1,
                               workers=2, backend="process") as loader:
            loader.warm_up()
            dev = prefetch_to_device(loader, depth=depth,
                                     place=lambda b: b, registry=reg)
            try:
                next(dev)  # cold batch
                waits = []
                for _ in range(5):  # the rest of the 6-batch epoch
                    time.sleep(0.05)  # the "train step"
                    t0 = time.perf_counter()
                    next(dev)
                    waits.append(time.perf_counter() - t0)
                # the median: on a loaded machine one late thread wake-up
                # stretches a single wait by several ms, and the mean of
                # two (the reference's) then inverts the comparison
                return statistics.median(waits) * 1e3
            finally:
                dev.close(close_source=False)

    sync_ms = stall_at(0)
    overlapped_ms = stall_at(2)
    print(f"image leg: stall {overlapped_ms:.2f} ms double-buffered vs "
          f"{sync_ms:.2f} ms synchronous", file=sys.stderr)
    assert overlapped_ms < sync_ms, (
        "no overlap: double-buffered stall did not beat synchronous "
        f"({overlapped_ms:.2f} >= {sync_ms:.2f} ms)")

    # --- LM leg: packed token stream through a DataService -------------
    prefix = os.path.join(work, "lm", "train")
    docs = synthetic_token_documents(64, vocab=256, mean_len=48, seed=2)
    sds = pack_token_documents(docs, prefix, seq_len=64, eos_id=255)
    import functools

    with DataService(functools.partial(_service_factory, prefix)) as svc:
        dev = prefetch_to_device(svc, depth=2, place=lambda b: b)
        n_tok = 0
        t0 = time.perf_counter()
        for _ in range(6):  # crosses the ~12-batch epoch? no: stays in it
            tokens, segments = next(dev)
            assert tokens.shape == (4, 64) and segments.shape == (4, 64)
            m = segment_loss_mask(segments)
            assert 0.0 < float(np.mean(m)) <= 1.0
            n_tok += tokens.size
        dt = time.perf_counter() - t0
        dev.close()  # passthrough closes the service too
    print(f"lm leg: {n_tok / dt:.0f} tokens/sec through "
          "DataService -> prefetch_to_device", file=sys.stderr)

    # --- clean shutdown -------------------------------------------------
    deadline = time.monotonic() + 15.0
    while mp.active_children() and time.monotonic() < deadline:
        time.sleep(0.1)
    leftover = mp.active_children()
    assert not leftover, f"leaked child processes: {leftover}"
    print("data_pipeline_smoke OK: overlap proven, shutdown clean",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    import tempfile

    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else
                  os.path.join(tempfile.gettempdir(),
                               "apex_tpu_torch_data_smoke")))
