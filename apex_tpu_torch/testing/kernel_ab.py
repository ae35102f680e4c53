"""Time N1 (row LayerNorm), L1 (the gathered LoRA delta) and K3 (the
bias + residual + LayerNorm epilogue) in several checkouts of the port, in
turn, on one card, so that the kernels of two commits are compared inside
one run::

    python -m apex_tpu_torch.testing.kernel_ab PARENT_DIR . . PARENT_DIR

Each directory is the root of a checkout (``git archive <commit> | tar -x
-C <dir>``).  Each runs in a process of its own with that checkout's
``apex_tpu_torch`` first on the path (so its kernels are built from its own
sources into its own ``build/``) and times, through the public entry points
that every slice since the norm slice has (``pallas_layer_norm``,
``lora_delta``, ``fused_residual_norm``):

- N1 at GPT-124M's training activation, 8192 rows of 768, with bf16 x over
  fp32 parameters, in fp32, and in bf16 throughout;
- L1 at the serving pair (bf16 x over the fp32 adapter arena), batch 8,
  rank 8, four adapters and the zero adapter, for each projection's
  (in, out) pair at S = 1, 5 and 128;
- K3 at hidden 768 and 8, 40 and 1024 rows (the decode step, the k + 1
  verify, a prefill chunk), bf16 x over a bf16 or an fp32 residual and in
  fp32, with a skip bias and fp32 parameters: the call alone, beside
  ``F.layer_norm`` on the pre-summed row (the same in every checkout: a
  yardstick and a control of the card's drift between runs), and after
  the dense projection that makes its x (``torch.matmul(ctx, W.t())``, the
  pair timed as one); and the host cost at 8 rows, microseconds from call
  to return (host clock, the median of 7 runs of 1000 calls with no
  synchronisation between them) of the public wrapper and of the C
  launcher alone, called with the same operands.

Each time is the median of 30 calls in CUDA events, with L2 flushed and a
spin kernel ahead of each, as ``chip_smoke.py`` times its kernels.  The
card's name and power limit come first, then one table: a row per case, a
column per directory in the order given.
"""

from __future__ import annotations

import os
import subprocess
import sys

# run in each checkout with its root as the working directory
_CASES = """
import gc, statistics, sys, time
sys.path.insert(0, ".")
import torch
import torch.nn.functional as F
from apex_tpu_torch import _build
from apex_tpu_torch.ops import pallas_norm as pn
from apex_tpu_torch.serving import fused_ops as fo
from apex_tpu_torch.serving import lora as lo

flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")


def timed(fn):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(30):
        flush.zero_()
        torch.cuda._sleep(4_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn):
    # host microseconds from call to return: the median of 7 runs of 1000
    # calls with no synchronisation between them (the collector off)
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    runs = []
    gc.disable()
    for _ in range(7):
        t0 = time.perf_counter()
        for _ in range(1000):
            fn()
        runs.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    gc.enable()
    return statistics.median(runs)


gen = torch.Generator(device="cuda").manual_seed(31)
bf16, f32 = torch.bfloat16, torch.float32
for label, xd, wd in (("bf16/fp32", bf16, f32), ("fp32", f32, f32),
                      ("bf16", bf16, bf16)):
    x = 2.0 * torch.randn((8192, 768), generator=gen, device="cuda") + 0.5
    w = torch.rand(768, generator=gen, device="cuda") + 0.5
    b = 0.1 * torch.randn(768, generator=gen, device="cuda")
    x, w, b = x.to(xd), w.to(wd), b.to(wd)
    ms = timed(lambda: pn.pallas_layer_norm(x, w, b))
    print(f"N1 {label} 8192x768|{ms:.4f}")
slots = torch.tensor([0, 1, 2, 0, 3, 3, 4, 1], dtype=torch.int32,
                     device="cuda")
for proj, (n_in, n_out) in (("qkv", (768, 2304)), ("dense", (768, 768)),
                            ("fc1", (768, 3072)), ("fc2", (3072, 768))):
    a = 0.25 * torch.randn((5, n_in, 8), generator=gen, device="cuda")
    bb = 0.5 * torch.randn((5, 8, n_out), generator=gen, device="cuda")
    a[0] = 0.0
    bb[0] = 0.0
    for S in (1, 5, 128):
        x = torch.randn((S, 8, n_in), generator=gen, device="cuda").to(bf16)
        print(f"L1 bf16/fp32 {proj} S={S}|"
              f"{timed(lambda: lo.lora_delta(x, a, bb, slots)):.4f}")
for label, xd, rd in (("bf16", bf16, bf16), ("bf16/fp32", bf16, f32),
                      ("fp32", f32, f32)):
    for rows in (8, 40, 1024):
        x = torch.randn((rows, 768), generator=gen, device="cuda").to(xd)
        res = (3 * torch.randn((rows, 768), generator=gen, device="cuda")).to(rd)
        bias = torch.randn(768, generator=gen, device="cuda").to(xd)
        w = torch.rand(768, generator=gen, device="cuda") + 0.5
        beta = 0.1 * torch.randn(768, generator=gen, device="cuda")
        ctx = torch.randn((rows, 768), generator=gen, device="cuda").to(xd)
        dense = (torch.randn((768, 768), generator=gen, device="cuda")
                 / 768 ** 0.5).to(xd)
        torch.cuda.synchronize()
        ms = timed(lambda: fo.fused_residual_norm(x, res, w, beta, bias=bias))
        print(f"K3 {label} rows={rows}|{ms:.4f}")
        summed = (x.float() + bias.float() + res.float()).to(xd)
        wl, bl = w.to(xd), beta.to(xd)
        ms = timed(lambda: F.layer_norm(summed, (768,), wl, bl))
        print(f"K3 {label} rows={rows} F.layer_norm|{ms:.4f}")
        ms = timed(lambda: fo.fused_residual_norm(
            torch.matmul(ctx, dense.t()), res, w, beta, bias=bias))
        print(f"K3 {label} rows={rows} after matmul|{ms:.4f}")
        if rows == 8:
            y, r = fo.fused_residual_norm(x, res, w, beta, bias=bias)
            fn = _build.library().apex_fused_residual_norm
            codes = [fo._DTYPE_CODES[t.dtype] for t in (x, res, w)]
            raw = codes[:len(fn.argtypes) - 11] + [
                t.data_ptr() for t in (x, res, bias, w, beta, y, r)] + [
                8, 768, 1e-5, torch.cuda.current_stream().cuda_stream]
            print(f"K3 {label} rows=8 host us/call|{host_us(lambda: fo.fused_residual_norm(x, res, w, beta, bias=bias)):.2f}")
            print(f"K3 {label} rows=8 launcher us/call|{host_us(lambda: fn(*raw)):.2f}")
"""


def main(dirs) -> int:
    if not dirs:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(f"card: {card.strip()}", flush=True)
    table, failed = {}, 0
    for j, d in enumerate(dirs):
        run = subprocess.run([sys.executable, "-c", _CASES],
                             cwd=os.path.abspath(d), capture_output=True,
                             text=True)
        if run.returncode:
            failed = 1
            print(f"{d}: failed\n{run.stdout[-2000:]}{run.stderr[-4000:]}",
                  flush=True)
            continue
        for line in run.stdout.splitlines():
            if "|" in line:
                case, ms = line.split("|")
                table.setdefault(case, {})[j] = ms.strip()
    print("case | " + " | ".join(dirs) + "  (ms)")
    for case, row in table.items():
        print(f"{case} | " + " | ".join(row.get(j, "-")
                                         for j in range(len(dirs))),
              flush=True)
    return failed


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
