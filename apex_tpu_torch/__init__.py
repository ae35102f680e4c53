"""apex_tpu_torch: the PyTorch/CUDA port of :mod:`apex_tpu`.

A second package beside the JAX reference, module for module
(``apex_tpu_torch/serving/paged_attention.py`` is the counterpart of
``apex_tpu/serving/paged_attention.py``, and so on).  It imports
:mod:`torch` and never JAX or :mod:`apex_tpu`.

Ported so far:

- the serving path of a GPT checkpoint through the paged KV cache
  (:mod:`apex_tpu_torch.serving`), with three kernels written by hand in
  CUDA C++ for Hopper (``csrc/``): paged decode attention, paged
  chunked-prefill attention and the fused residual/LayerNorm epilogue;
- single-device GPT training (:mod:`apex_tpu_torch.transformer.testing.
  standalone_gpt`, :mod:`apex_tpu_torch.optimizers`,
  :mod:`apex_tpu_torch.testing.l1`) through either attention core: the
  default fused-softmax one (:mod:`apex_tpu_torch.ops.softmax`, also at
  :mod:`apex_tpu_torch.transformer.functional`), or the flash forward and
  backward kernels (``csrc/flash_attention.cu``) through
  :mod:`apex_tpu_torch.ops.flash_attention`;
- mixed precision (:mod:`apex_tpu_torch.amp`: the O0-O3 policies,
  dynamic, static and no-op loss scaling, master weights, ``initialize``
  with its state dict, fp8 with delayed scaling, whose GEMMs run on the
  card's fp8 tensor cores through ``torch._scaled_mm``; the transformer's
  :class:`~apex_tpu_torch.transformer.amp.GradScaler`), with FusedAdam's
  ``master_weights``, ``flat`` and ``step(lr=, grad_scale=,
  skip_update=)``;
- speculative k+1 verify and multi-LoRA serving, with the gathered
  LoRA-delta kernel (``csrc/lora_delta.cu``);
- tensor, sequence and data parallelism over ``torch.distributed``
  (:mod:`apex_tpu_torch.parallel`: the rank grid, the collectives,
  ``DistributedDataParallel``; :mod:`apex_tpu_torch.transformer.
  tensor_parallel`: the mapping regions, the parallel layers, the
  vocab-parallel cross entropy, the ring-overlapped collective matmul),
  with the standalone GPT holding a rank's shards (NCCL on the card, gloo
  on the CPU);
- pipeline parallelism (:mod:`apex_tpu_torch.transformer.
  pipeline_parallel`: the rotation schedule with interleaved chunks, the
  1F1B and interleaved entry points, the p2p transfers, the microbatch
  calculators) and the 3D-parallel GPT step that composes it all
  (``transformer.testing.gpt_parallel_train.build_gpt_3d``), with the
  non-finite sentinel (:mod:`apex_tpu_torch.resilience`) and the packed
  loss mask (:mod:`apex_tpu_torch.data`);
- the rest of the serving engine: tensor-parallel serving (one engine
  per rank of a tp group, holding its heads, weight shards and adapter
  shards), worst-case ``"reserve"`` admission, the unfused paged
  attention A/B, KV export and import between engines, live knobs, the
  metrics registry, MFU, the flight recorder's timeline
  (:mod:`apex_tpu_torch.observability`) and the drain on a
  :class:`~apex_tpu_torch.resilience.PreemptionGuard`;
- the normalization API (:mod:`apex_tpu_torch.normalization`: fused
  LayerNorm and RMSNorm, affine or not, mixed-dtype modules, the
  memory-efficient backward) and the row-norm entry points
  :func:`apex_tpu_torch.ops.pallas_norm.pallas_layer_norm` /
  ``pallas_rms_norm``, whose forwards are the row LayerNorm and RMSNorm
  kernels (``csrc/row_norm.cu``).

- ResNet training, the BASELINE workload: the ResNet family
  (:mod:`apex_tpu_torch.models`), SyncBatchNorm
  (:mod:`apex_tpu_torch.parallel`), the whole fused optimizer family on
  the chunked buffers of :mod:`apex_tpu_torch.utils`, the synthetic
  ImageNet batches (:mod:`apex_tpu_torch.data`) and the ``rn50_*`` L1
  cells (:mod:`apex_tpu_torch.testing.l1`); plain PyTorch ops, as the
  reference's are plain XLA.

Every TPU kernel of the JAX package has its hand-written counterpart
here, nine in all.  Entry points run on the CUDA device unless given
``device="cpu"`` or CPU tensors, where each kernel's plain PyTorch version
runs instead.
"""

__all__ = ["serving", "transformer", "normalization", "ops", "optimizers",
           "amp", "parallel", "resilience", "data", "testing",
           "observability", "models", "utils"]
