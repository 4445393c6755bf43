"""Hopper labs: the TPU labs under ``tools/`` as CUDA kernels for an H100.

Each lab module holds a kernel's wrapper (it launches the CUDA kernel for
CUDA tensors and takes the plain PyTorch version for CPU tensors), that
plain version, and a ``main`` that times the kernel at the TPU lab's
default shapes beside its bound:

  profile_rebin_lwfa  L5, the DMA slot copy          (csrc/slot_copy.cu)
  bench_dot_shapes    L4, tile products vs M         (csrc/tile_dot.cu)
  bench_deposit_prec  L3, deposit products vs type   (csrc/tile_dot.cu)
  kernel_lab          L1, ablations of the fused body (csrc/lab_fused.cu)
  lab_widelane        L2, batched vs wide particle axis (csrc/lab_widelane.cu)

Run one on the card with ``python -m warpx_tpu_torch.tools.<lab>``, or on
the CPU (plain versions, any size) with ``--device cpu``.
"""
