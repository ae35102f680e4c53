"""Time GPT-124M's bf16 training step in several checkouts of the port, in
turn, on one card, so that two commits are compared inside one run::

    python -m apex_tpu_torch.testing.step_ab PARENT_DIR . . PARENT_DIR

Each directory is the root of a checkout (``git archive <commit> | tar -x
-C <dir>``).  Each runs in a process of its own with that checkout's
``apex_tpu_torch`` first on the path (so its kernels are built from its own
sources into its own ``build/``), and prints the card's name and power
limit and one line per run: the step time over ``TIMED_STEPS`` steps after
``WARMUP_STEPS`` (host clock, ending in a device sync) and the flash
kernels' launches.  The step is ``bench.py``'s flash step as
``chip_smoke.py`` phase 5 runs it: hidden 768, 12 layers, 12 heads of 64,
vocabulary 50304, batch 8 x 1024, bf16 compute over fp32 parameters,
FusedAdam at lr 1e-4, one fixed batch.  Only the public API that every
slice since the training slice has is used, so older checkouts run it
too.  Run the order parent, change, change, parent: the step is bound by
the host, whose speed drifts within a run.
"""

from __future__ import annotations

import os
import subprocess
import sys

WARMUP_STEPS, TIMED_STEPS = 2, 8

# run in each checkout with its root as the working directory
_STEP = f"""
import importlib, sys, time
sys.path.insert(0, ".")
import torch
fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.testing.l1 import train_step
from apex_tpu_torch.transformer.testing.gpt_parallel_train import init_gpt_params
from apex_tpu_torch.transformer.testing.standalone_gpt import GPTModel
from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
    TransformerConfig)

cfg = TransformerConfig(hidden_size=768, num_layers=12, num_attention_heads=12,
                        padded_vocab_size=50304, max_position_embeddings=1024,
                        hidden_dropout=0.0, attention_dropout=0.0,
                        use_flash_attention=True, dtype=torch.bfloat16)
model = GPTModel(cfg, device="cuda")
model.load_params(init_gpt_params(cfg, 0, device="cuda"))
opt = FusedAdam(model.parameters(), lr=1e-4)
gen = torch.Generator(device="cuda").manual_seed(3)
tokens = torch.randint(0, 50257, (8, 1024), generator=gen, device="cuda")
for _ in range({WARMUP_STEPS}):
    train_step(model, opt, tokens)
torch.cuda.synchronize()
fa.FWD_LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = 0
t0 = time.perf_counter()
for _ in range({TIMED_STEPS}):
    loss = train_step(model, opt, tokens)
torch.cuda.synchronize()
wall = time.perf_counter() - t0
print(f"step {{wall / {TIMED_STEPS} * 1e3:.3f}} ms, loss {{float(loss):.4f}}, "
      f"launches F1/F2/F3 {{fa.FWD_LAUNCHES}}/{{fa.DQ_LAUNCHES}}/"
      f"{{fa.DKV_LAUNCHES}} over {TIMED_STEPS} steps")
"""


def main(dirs) -> int:
    if not dirs:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(f"card: {card.strip()}", flush=True)
    failed = 0
    for d in dirs:
        run = subprocess.run([sys.executable, "-c", _STEP],
                             cwd=os.path.abspath(d), capture_output=True,
                             text=True)
        last = run.stdout.strip().splitlines()[-1:] or [""]
        print(f"{d}: {last[0] if run.returncode == 0 else 'failed'}",
              flush=True)
        if run.returncode:
            failed = 1
            print(run.stdout[-2000:] + run.stderr[-4000:], flush=True)
    return failed


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
