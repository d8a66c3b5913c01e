"""sstts_torch: the PyTorch/CUDA port of sstts for NVIDIA Hopper.

A second package beside the JAX reference `sstts`, which it never imports.
Entry point: `sstts_torch.synthesize.Synthesizer`.  The hand-written CUDA
kernels live in `sstts_torch/csrc/` and are built with `nvcc` on first use
(`sstts_torch.ops.build`).
"""
