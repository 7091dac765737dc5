"""The paper's contribution, ported: ODM / SODM solvers (Algorithm 1).

  kernel_fns  — KernelSpec + gram computations
  odm         — dual objective, gradient, warm-start scale, prediction
  dual_cd     — dual coordinate descent (exact + block-Gauss-Seidel)
  partition   — Section 3.2 distribution-aware partitioning (Eqn. 7-8)
  engines     — level solvers (scalar | block | pallas)
  sodm        — Algorithm 1 (hierarchical merge, warm starts)
"""
