"""PyTorch + CUDA port of butd_detr_tpu for NVIDIA Hopper (sm_90a).

The JAX package `butd_detr_tpu` is the reference this package is held
against; nothing here imports it. Entry points run on `cuda` unless the
caller passes `device="cpu"`. The seven TPU kernels of the JAX package
(FPS, ball query, the attention forward and backward, the row scatter-add,
the row gather and the grouped gather) are hand-written CUDA kernels here
(`csrc/`), built with `nvcc` at their first CUDA use; beside each one lives
its plain PyTorch version, which the wrapper uses only for tensors that lie
on the CPU.
"""
