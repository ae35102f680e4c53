"""Crash/resume trainer, the end-to-end resilience proof (port of the GPT
and ZeRO legs of :mod:`apex_tpu.testing.crash_resume`).

A real run of the 3D-parallel GPT trainer (:func:`~apex_tpu_torch.
transformer.testing.gpt_parallel_train.build_gpt_3d`, the sentinel armed,
``FusedAdam``) on one rank, checkpointing every ``--save-every`` steps
through :class:`~apex_tpu_torch.resilience.CheckpointManager` (async
sharded saves, the :class:`~apex_tpu_torch.resilience.reshard.
ShardingSpec` embedded).  The state saved is the reference's tree:
``{"params": GPT3DParams, "opt": OptState(step, slots={"exp_avg",
"exp_avg_sq"}, master), "sent": SentinelState}``.  Run it three ways
(uninterrupted, SIGKILLed after a commit, ``--resume``d) and the resumed
loss curve equals the uninterrupted one bit for bit.

Steps count from 1; step ``i``'s loss is appended to ``--losses`` as
``"{i} {fp32 bits as hex}"`` (flushed and fsynced per line, so a SIGKILL
loses at most the line in flight), and a save at step ``i`` is step
``i``'s checkpoint.  A finished async save is committed as soon as the
loop sees it done, so a commit never waits for the next save.

SIGTERM (preemption) is handled by :class:`~apex_tpu_torch.resilience.
PreemptionGuard`: drain the in-flight async save, take a final
synchronous checkpoint of the step just finished, exit 0.

Determinism: the tokens of step ``i`` come from a ``torch.Generator``
seeded from ``(seed, i)`` over the global batch, so any resume point
replays the same stream; the run sets ``torch.use_deterministic_algorithms
(True)`` (and ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` before CUDA starts).

``--config tiny`` is the reference harness's model (hidden 32, vocab 64,
sequence 16, one layer, two heads), ``gpt124m`` GPT-124M at ``bench.py``'s
flash widths (hidden 768, 12 layers, 12 heads, vocab 50304, sequence
1024, bf16 compute, fp32 parameters, flash attention).  A completed run
prints one JSON line, ``{"crash_resume": {...}}``: the step it started
from, the sentinel's skipped steps, the restore's fallback depth and
this process's flash-kernel launches by route (tc, simt).  ``--fingerprint``
writes the mesh-independent digest of the newest committed checkpoint
(:func:`~apex_tpu_torch.resilience.reshard.load_logical`, one
``"{leaf} {dtype} {shape} {sha256}"`` line a leaf).  ``--device``
defaults to ``cuda``.

``--zero`` runs the reference's ZeRO leg instead: a small least-squares
fit (``w`` 13 x 7, ``b`` 7) under ``zero_data_parallel_train_step`` with
``DistributedFusedAdam(flat_bucket=True, n_buckets=2)`` and the sentinel,
on ``--devices`` data-parallel ranks (gloo on the CPU, NCCL on cards),
each step's global batch of ``--global-batch`` rows drawn from ``(seed,
step)`` and split over the ranks.  Its optimizer buckets are shaped by
the world size, so a ``--resume`` at another ``--devices`` reshards them
(:func:`~apex_tpu_torch.resilience.reshard.restore_resharded`).  With
``--devices`` N > 1 the command starts N rank processes of itself (each
killed with it) and waits for them; rank 0 writes the losses and the
fingerprint.  The GPT leg runs one rank (``--tp`` / ``--pp`` and its
elastic legs are not ported: ROADMAP.md, section A.2).

Usage::

    python -m apex_tpu_torch.testing.crash_resume --ckpt-dir D \\
        --losses L --steps 6 --save-every 2 [--resume] [--config gpt124m]
    python -m apex_tpu_torch.testing.crash_resume --zero --devices 4 \\
        --device cpu --global-batch 8 --ckpt-dir D --losses L [--resume]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

CONFIGS = {
    # name -> (hidden, layers, heads, vocab, seq, microbatches x rows)
    "tiny": dict(hidden=32, layers=1, heads=2, vocab=64, seq=16, rows=2),
    "gpt124m": dict(hidden=768, layers=12, heads=12, vocab=50304, seq=1024,
                    rows=2),
}
MICROBATCHES = 2


def _append_loss(path: str, step: int, loss) -> None:
    import numpy as np

    with open(path, "a") as f:
        f.write(f"{step} {np.float32(loss).tobytes().hex()}\n")
        f.flush()
        os.fsync(f.fileno())


def _truncate_losses(path: str, last_step: int) -> None:
    """Keep the loss lines of steps <= ``last_step`` (a crash may have
    logged steps newer than the newest durable checkpoint)."""
    if not os.path.exists(path):
        return
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines()
                 if ln and int(ln.split()[0]) <= last_step]
    with open(path, "w") as f:
        f.write("".join(ln + "\n" for ln in lines))
        f.flush()
        os.fsync(f.fileno())


def _write_fingerprint(out_path: str, mgr) -> None:
    """One ``"{logical leaf} {dtype} {shape} {sha256}"`` line a leaf of
    the newest committed checkpoint, sorted."""
    import hashlib

    import numpy as np

    from apex_tpu_torch.resilience import reshard

    step = next((s for s in reversed(mgr.all_steps())
                 if mgr._is_committed(s)), None)
    if step is None:
        raise SystemExit("fingerprint: no committed checkpoint")
    leaves, at = reshard.load_logical(mgr.step_path(step))
    lines = [f"step {at}\n"]
    for key in sorted(leaves):
        arr = np.asarray(leaves[key], order="C")
        digest = hashlib.sha256(arr.tobytes()).hexdigest()
        lines.append(f"{key} {arr.dtype} {list(arr.shape)} {digest}\n")
    with open(out_path, "w") as f:
        f.writelines(lines)
        f.flush()
        os.fsync(f.fileno())


def model_config(name: str):
    """The ``TransformerConfig`` of ``--config name``."""
    import torch

    from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
        TransformerConfig,
    )

    c = CONFIGS[name]
    big = name == "gpt124m"
    return TransformerConfig(
        hidden_size=c["hidden"], num_layers=c["layers"],
        num_attention_heads=c["heads"], padded_vocab_size=c["vocab"],
        max_position_embeddings=c["seq"], hidden_dropout=0.0,
        attention_dropout=0.0, use_flash_attention=big,
        dtype=torch.bfloat16 if big else torch.float32)


def tokens_for_step(step: int, *, seed: int, batch: int, seq: int,
                    vocab: int, device):
    """Step ``step``'s global batch: a generator seeded from ``(seed,
    step)``, so every resume point replays the same stream."""
    import torch

    gen = torch.Generator().manual_seed(seed * 1_000_003 + step)
    return torch.randint(0, vocab, (batch, seq), generator=gen,
                         dtype=torch.int64).to(device)


def build_trainer(config_name: str, device, *, lr: float = 1e-4):
    """``(pack, step_fn, spec, opt, cfg)``: the train state as the
    reference's tree, the sentinel-guarded step, its ShardingSpec, the
    optimizer and the model config."""
    from apex_tpu_torch.amp._tree import tree_leaves
    from apex_tpu_torch.amp.scaler import DynamicLossScale
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.resilience import reshard, sentinel_init
    from apex_tpu_torch.transformer.testing.gpt_parallel_train import (
        build_gpt_3d,
        gpt3d_logical_folds,
    )
    from apex_tpu_torch.transformer.tensor_parallel.partition import (
        PartitionSpec,
    )

    cfg = model_config(config_name)
    init_fn, _, make_train_step = build_gpt_3d(
        cfg, num_chunks=cfg.num_layers, num_microbatches=MICROBATCHES,
        device=device)
    params, specs = init_fn(seed=0)
    opt = FusedAdam(tree_leaves(params), lr=lr)
    scaler = DynamicLossScale()
    sent = sentinel_init(scaler, device)
    step_fn = make_train_step(opt, specs, scaler=scaler)
    pack = {"params": params, "opt": opt.opt_state(params), "sent": sent}
    rep = PartitionSpec()
    pack_specs = {"params": specs,
                  "opt": type(pack["opt"])(
                      step=rep, slots={k: specs for k in pack["opt"].slots},
                      master=None),
                  "sent": rep}
    spec = reshard.build_spec(pack, folds=gpt3d_logical_folds(pack),
                              specs=pack_specs)
    return pack, step_fn, spec, opt, cfg


def load_pack(pack, restored, opt) -> dict:
    """Copy a restored train state into the live one (the optimizer
    holds the parameter tensors); returns the new pack."""
    import torch

    from apex_tpu_torch.amp._tree import tree_leaves

    params = pack["params"]
    with torch.no_grad():
        for p, r in zip(tree_leaves(params),
                        tree_leaves(restored["params"])):
            p.copy_(r)
    opt.load_opt_state(params, restored["opt"])
    return {"params": params, "opt": opt.opt_state(params),
            "sent": restored["sent"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--losses", required=True)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--save-every", type=int, default=1)
    ap.add_argument("--keep", type=int, default=2)
    ap.add_argument("--config", choices=sorted(CONFIGS), default="tiny")
    ap.add_argument("--seed", type=int, default=7,
                    help="seed of the token stream")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest intact checkpoint and go on "
                         "from the step after it")
    ap.add_argument("--flat", action="store_true",
                    help="flat single-file layout instead of sharded")
    ap.add_argument("--fingerprint", default=None,
                    help="after the run, write the logical digest of the "
                         "newest committed checkpoint to this path")
    ap.add_argument("--step-delay", type=float, default=0.0,
                    help="sleep this many seconds after each step, a "
                         "deterministic window for an external killer")
    ap.add_argument("--zero", action="store_true",
                    help="the flat-bucket ZeRO trainer instead of the GPT "
                         "(data-parallel ranks only; its optimizer buckets "
                         "are shaped by the world size)")
    ap.add_argument("--devices", type=int, default=1,
                    help="data-parallel ranks of the ZeRO leg (started "
                         "as processes of this command)")
    ap.add_argument("--global-batch", type=int, default=8,
                    help="the ZeRO leg's rows a step, the same at any "
                         "--devices")
    args = ap.parse_args(argv)
    if args.zero:
        if "CRASH_RESUME_LAUNCHER" in os.environ:
            _die_with_parent()
        elif args.devices > 1:
            return _launch_ranks(sys.argv[1:] if argv is None else argv,
                                 args.devices)
        return _zero_leg(args)
    if args.devices != 1:
        raise SystemExit("the GPT leg runs one rank (--devices 1); "
                         "several ranks are the --zero leg's")

    # before CUDA starts: cuBLAS picks deterministic workspaces
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import time

    import numpy as np
    import torch

    from apex_tpu_torch._device import resolve_device
    from apex_tpu_torch.observability import timeline
    from apex_tpu_torch.resilience import CheckpointManager, PreemptionGuard

    torch.use_deterministic_algorithms(True)
    device = resolve_device(args.device)
    if device.type == "cpu":
        torch.set_num_threads(1)
    pack, step_fn, spec, opt, cfg = build_trainer(args.config, device,
                                                  lr=args.lr)
    c = CONFIGS[args.config]
    batch = MICROBATCHES * c["rows"]
    mgr = CheckpointManager(args.ckpt_dir, keep=args.keep,
                            sharded=not args.flat, spec=spec)
    recorder = timeline.arm_from_env()

    start, depth = 1, None
    if args.resume:
        from apex_tpu_torch.observability.metrics import default_registry

        skipped = default_registry().counter("ckpt/fallback_depth")
        before = skipped.value
        try:
            restored, at = mgr.restore_latest(pack)
            depth = int(skipped.value - before)
            pack = load_pack(pack, restored, opt)
            start = at + 1
            _truncate_losses(args.losses, at)
            print(f"crash_resume: resumed from step {at} (fallback depth "
                  f"{depth})", file=sys.stderr)
        except FileNotFoundError as e:
            _truncate_losses(args.losses, 0)
            print(f"crash_resume: no intact checkpoint ({e}); "
                  "restarting from step 1", file=sys.stderr)

    params, sent = pack["params"], pack["sent"]
    guard = PreemptionGuard()
    handle, saved = None, start - 1
    try:
        for i in range(start, args.steps + 1):
            tokens = tokens_for_step(i, seed=args.seed, batch=batch,
                                     seq=c["seq"], vocab=c["vocab"],
                                     device=device)
            t_step = time.monotonic()
            sent, loss = step_fn(params, tokens, sent)
            loss = float(loss)
            if recorder is not None:
                recorder.emit("step", dur_s=time.monotonic() - t_step,
                              step=i)
            _append_loss(args.losses, i, loss)
            if handle is not None and handle.done():
                mgr.wait()  # commit the finished save now
                handle = None
            if i % args.save_every == 0:
                state = {"params": params, "opt": opt.opt_state(params),
                         "sent": sent}
                handle = mgr.save_async(state, i)
                saved = i
            if args.step_delay > 0:
                time.sleep(args.step_delay)
            if guard.triggered:
                if recorder is not None:
                    recorder.preemption(step=i)
                with timeline.scope("drain", step=i):
                    mgr.wait()
                if saved != i:
                    mgr.save({"params": params, "opt": opt.opt_state(params),
                              "sent": sent}, i)
                print(f"crash_resume: preempted, drained and saved at step "
                      f"{i}, clean exit", file=sys.stderr)
                return 0
        mgr.wait()
        if recorder is not None:
            recorder.flush()
    finally:
        guard.uninstall()
    if args.fingerprint:
        _write_fingerprint(args.fingerprint, mgr)
    print(f"crash_resume: completed {args.steps} steps "
          f"(skipped_steps={int(sent.skipped_steps)})", file=sys.stderr)
    print(json.dumps({"crash_resume": {
        "start": start, "steps": args.steps,
        "skipped_steps": int(sent.skipped_steps),
        "fallback_depth": depth,
        "launches": _flash_launches()}}), flush=True)
    return 0


def _die_with_parent() -> None:
    """In a rank process: be killed when its launcher dies (Linux
    ``PR_SET_PDEATHSIG``), so a SIGKILL of the command ends its ranks
    too; a launcher already gone ends the rank at once."""
    import ctypes
    import signal

    try:
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        return
    if os.getppid() != int(os.environ["CRASH_RESUME_LAUNCHER"]):
        os._exit(1)


def _launch_ranks(argv, n: int) -> int:
    """Run ``n`` rank processes of this command (with the environment
    :func:`~apex_tpu_torch.parallel.initialize_distributed` reads) and
    wait; when one fails, the others are killed.  Returns the first
    non-zero exit code, else 0."""
    import socket
    import subprocess
    import time

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        address = f"127.0.0.1:{s.getsockname()[1]}"
    procs = []
    for rank in range(n):
        env = dict(os.environ, COORDINATOR_ADDRESS=address,
                   NUM_PROCESSES=str(n), PROCESS_ID=str(rank),
                   CRASH_RESUME_LAUNCHER=str(os.getpid()))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "apex_tpu_torch.testing.crash_resume",
             *argv], env=env))
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed or all(c == 0 for c in codes):
                return failed[0] if failed else 0
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def _zero_leg(args) -> int:
    """The ZeRO leg on this rank (see the module docstring)."""
    import time

    import torch
    import torch.distributed as dist

    from apex_tpu_torch import parallel
    from apex_tpu_torch._device import resolve_device
    from apex_tpu_torch.amp._tree import tree_leaves
    from apex_tpu_torch.amp.scaler import DynamicLossScale
    from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam
    from apex_tpu_torch.resilience import (
        CheckpointManager,
        PreemptionGuard,
        reshard,
        sentinel_init,
    )

    device = resolve_device(args.device)
    if device.type == "cpu":
        torch.set_num_threads(1)
    parallel.initialize_distributed(device=device)
    try:
        parallel.initialize_model_parallel()
        dp = parallel.get_data_parallel_world_size()
        if args.global_batch % dp:
            raise SystemExit(f"global batch {args.global_batch} not "
                             f"divisible by dp {dp}")
        rank0 = dist.get_rank() == 0
        gen = torch.Generator().manual_seed(0)
        params = {"b": torch.zeros(7, device=device).requires_grad_(),
                  "w": torch.randn(13, 7, generator=gen).to(device)
                  .requires_grad_()}
        opt = DistributedFusedAdam(tree_leaves(params), lr=1e-2,
                                   flat_bucket=True, n_buckets=2)
        parallel.zero_init(opt, params)
        scaler = DynamicLossScale()
        sent = sentinel_init(scaler, device)
        step_fn = parallel.zero_data_parallel_train_step(
            lambda b: torch.mean((b[0] @ params["w"] + params["b"] - b[1])
                                 ** 2), opt, scaler=scaler)

        def batch(i):
            g = torch.Generator().manual_seed(args.seed * 1_000_003 + i)
            x = torch.randn(args.global_batch, 13, generator=g)
            y = torch.randn(args.global_batch, 7, generator=g)
            return parallel.dp_shard_batch((x.to(device), y.to(device)))

        def state():
            return {"params": params, "opt": opt.opt_state(params),
                    "sent": sent}

        spec = reshard.build_spec(state(), mesh=parallel.get_mesh(),
                                  zero_states=[("opt", opt, params)])
        mgr = CheckpointManager(args.ckpt_dir, keep=args.keep,
                                sharded=not args.flat, spec=spec)
        start = 1
        if args.resume:
            try:
                restored, at = mgr.restore_latest(state())
            except FileNotFoundError as e:
                if rank0:
                    _truncate_losses(args.losses, 0)
                print(f"crash_resume: no intact checkpoint ({e}); "
                      "restarting from step 1", file=sys.stderr)
            else:
                with torch.no_grad():
                    for k, p in params.items():
                        p.copy_(restored["params"][k])
                opt.load_opt_state(params, restored["opt"])
                sent = restored["sent"]
                start = at + 1
                if rank0:
                    _truncate_losses(args.losses, at)
                    print(f"crash_resume: resumed from step {at}",
                          file=sys.stderr)
        guard = PreemptionGuard()
        try:
            for i in range(start, args.steps + 1):
                sent, loss = step_fn(batch(i), sent)
                if rank0:
                    _append_loss(args.losses, i, float(loss))
                if i % args.save_every == 0:
                    mgr.save_async(state(), i)
                if args.step_delay > 0:
                    time.sleep(args.step_delay)
                if guard.triggered:
                    mgr.wait()
                    if i % args.save_every:
                        mgr.save(state(), i)
                    print(f"crash_resume: preempted, drained and saved at "
                          f"step {i}, clean exit", file=sys.stderr)
                    return 0
            mgr.wait()
        finally:
            guard.uninstall()
        dist.barrier()
        if args.fingerprint and rank0:
            _write_fingerprint(args.fingerprint, mgr)
        if rank0:
            print(json.dumps({"crash_resume": {
                "start": start, "steps": args.steps, "dp": dp,
                "skipped_steps": int(sent.skipped_steps)}}), flush=True)
        return 0
    finally:
        parallel.destroy_model_parallel()
        dist.destroy_process_group()


def _flash_launches() -> dict:
    """This process's F1-F3 launches by route (the wrappers' counters)."""
    import importlib

    # (the package exports the function of the same name)
    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")

    return {"flash_fwd": [fa.FWD_TC_LAUNCHES, fa.FWD_SIMT_LAUNCHES],
            "flash_dq": [fa.DQ_TC_LAUNCHES, fa.DQ_SIMT_LAUNCHES],
            "flash_dkv": [fa.DKV_TC_LAUNCHES, fa.DKV_SIMT_LAUNCHES]}


if __name__ == "__main__":
    sys.exit(main())
