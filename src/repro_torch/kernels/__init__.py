"""Hand-written Hopper kernels of the ported paths, each beside its plain
PyTorch version. Port of ``repro.kernels``.

  gram          — tile skeleton (accum_tile / finalize_tile) and the
                  batched Gram matvec, K2 (csrc/gram_matvec.cu)
  dual_cd_block — greedy tile sweep K1 (csrc/cd_sweep.cu), dense signed-Q
                  matvec K3 (csrc/dense_matvec.cu), the fused pass and the
                  level solve
  score         — serving scorer (K2 with one partition)
  odm_grad      — DSVRG's fused primal gradients, B6 (inner direction) and
                  B7 (full-batch anchor gradient) (csrc/odm_grad.cu)
  ops           — shape-handling entry points used by framework code

A CPU tensor takes a kernel's plain version, a CUDA tensor the kernel
(:mod:`repro_torch.kernels._device`); the CUDA sources are built with
nvcc at first use (:mod:`repro_torch.kernels._build`).
"""
