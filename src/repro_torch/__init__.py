"""PyTorch/CUDA port of the PW-advection system for NVIDIA Hopper (H100).

The JAX package `repro` is the reference; this package never imports it
(or JAX). Its main path is single-device fused PW advection:
`stencil.advection.AdvectionDomain(variant="fused")` ->
`kernels.advection.ops.pw_advect_fused` -> `kernels.advection.advection.
advect_fused`, which launches the hand-written CUDA ring kernel in
`csrc/advect_fused.cuh`; `finite_guard` launches `csrc/finite_guard.cu`;
the other ladder rungs launch `csrc/advect_blocked.cu` and
`csrc/advect_dataflow.cu`. The stencil-spec frontend (`stencil.spec`)
drives `kernels.advection.advection.stencil_fused`, which launches
`csrc/stencil_fused.cu`. The dense-model token-serving path
(`serving.engine.ServingEngine` -> `models.model.forward` /
`decode_step` -> `models.blocks.attention_apply`) launches the flash-
attention kernel, `csrc/flash_attention_tc.cu` for bf16 and
`csrc/flash_attention.cu` for f32, through
`kernels.attention.ops.gqa_layout_attention` in every prefill when
`attention_impl="pallas"`. All are built by `nvcc` at first use
(`_build.py`). On CPU tensors each
wrapper runs its plain PyTorch version instead, which is what the CPU test
tier holds against the JAX reference. Training (`launch.train` ->
`training.step.make_train_step` -> `models.model.loss_fn`, AdamW in
`training.optimizer`) runs plain PyTorch, as the reference's runs jnp:
the kernel routes are forward-only and refuse a gradient.
"""
