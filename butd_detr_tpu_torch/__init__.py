"""PyTorch + CUDA port of butd_detr_tpu for NVIDIA Hopper (sm_90a).

The JAX package `butd_detr_tpu` is the reference this package is held
against; nothing here imports it. Entry points run on `cuda` unless the
caller passes `device="cpu"`. The TPU kernels of the serving path (FPS,
ball query, the attention forward) are hand-written CUDA kernels here
(`csrc/`), built with `nvcc` at their first CUDA use; beside each one lives
its plain PyTorch version, which the wrapper uses only for tensors that lie
on the CPU.
"""
