"""Multi-device execution over ``torch.distributed``, one rank per device.

The counterpart of ``warpx_tpu.parallel``: the spatial mesh of ranks
(``topology``), the initial layout of the state over it (``distribute``),
guard-cell halos and the particle exchange between face neighbours
(``halo``, ``particles``), the cost-driven tile assignment of dynamic load
balancing (``load_balance``), and the process start of a local group of
ranks (``launch``).  NCCL carries CUDA tensors, gloo CPU tensors.
"""
