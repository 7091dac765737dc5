"""The paper's contribution, ported: ODM / SODM (Algorithm 1) and DSVRG
(Algorithm 2) solvers.

  kernel_fns  — KernelSpec + gram computations
  odm         — dual and primal objectives and gradients, prediction
  dual_cd     — dual coordinate descent (exact + block-Gauss-Seidel)
  partition   — Section 3.2 distribution-aware partitioning (Eqn. 7-8)
  engines     — level solvers (scalar | block | pallas)
  sodm        — Algorithm 1 (hierarchical merge, warm starts)
  dsvrg       — Algorithm 2 (linear kernel, primal SVRG)
"""
