"""evostencils_tpu — automated design of multigrid solvers via
grammar-guided genetic programming (G3P), evaluated on the accelerator.

A ground-up JAX/XLA re-design of the capabilities of
jonas-schmitt/evostencils: instead of emitting ExaSlang DSL, invoking the
ExaStencils Java compiler and g++ per individual, every evolved multigrid
cycle is lowered directly to a jit-compiled JAX function built from fused
stencil kernels and executed on the GPU.  Fitness evaluation (asymptotic
convergence factor + on-device wall clock) therefore runs at device speed
with zero subprocess boundaries.

Layer map (mirrors SURVEY.md §1):

    stencils/      sparse offset->value stencil algebra (constant + periodic)
    ir/            matrix-free expression IR (Cycle / Residual / Inverse / ...)
    grammar/       typed G3P grammar over multigrid state machines
    ops/           JAX compute kernels (smoothers, intergrid, solves) and
                   their float64 numpy references
    backend/       IR -> jitted cycle compiler + on-device evaluation harness
    models/        model-based prediction: JAX LFA + device roofline
    optimization/  EA drivers (SOGP / NSGA-II / NSGA-III), caching, checkpoints
    problems/      built-in PDE problem specs (Poisson, elasticity, Helmholtz, FAS)
    parallel/      device-mesh sharding: population dispatch + spatial halo shards
    utils/         logbooks, hall-of-fame, peaks table, tree visualization
"""

__version__ = "0.1.0"
