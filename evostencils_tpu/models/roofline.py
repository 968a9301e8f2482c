"""Roofline performance model of the device the program runs on.

Same estimation structure as the reference PerformanceEvaluator
(model_based_prediction/performance.py:6-271): walk the cycle IR counting
operations and transferred words per grid cell, convert to runtime via
min(peak_compute, AI · bandwidth), add per-node runtimes bottom-up with
memoization; red-black sweeps get an empirical penalty factor; the
coarse-grid-solver cost is injected (here: the cost of one dense matvec
of the assembled inverse).

Peaks come from utils/peaks.py, keyed by the device kind; an unknown
device raises.  Stencil sweeps are bandwidth-bound at these ratios,
exactly as on the reference's CPU — only the constants change.

Calibration: the empirical factors (red-black penalty, XLA fusion,
single-sweep fusion, intergrid surcharge, kernel launch overhead) are
neutral (1.0 / 0.0) until scripts/calibrate_roofline.py has fitted them to
per-cycle device timings on the card.  The reference's 1.4303… penalty
was likewise "experimentally obtained" (performance.py:93-94).

Besides runtime the walker also accumulates the modeled HBM traffic in
bytes (`estimate_traffic`), which divided by a measured per-cycle time
gives an achieved-bandwidth upper bound.
"""

from __future__ import annotations

from functools import reduce

from evostencils_tpu.ir import base, partitioning, system
from evostencils_tpu.stencils import periodic
from evostencils_tpu.utils.peaks import current_device_peaks, peaks_for


class PerformanceEvaluator:
    def __init__(
        self,
        device_kind: str | None = None,
        bytes_per_word: int = 4,
        runtime_coarse_grid_solver: float = 0.0,
        red_black_penalty: float = 1.0,
        kernel_launch_overhead: float = 0.0,
        fusion_factor: float = 1.0,
        single_sweep_fusion: float = 1.0,
        intergrid_factor: float = 1.0,
    ):
        """``device_kind`` selects the peaks (None: the first JAX device)."""
        peaks = (
            current_device_peaks() if device_kind is None
            else peaks_for(device_kind)
        )
        self.peak_performance = peaks.f32_flops
        self.peak_bandwidth = peaks.hbm_bytes_per_s
        self.bytes_per_word = bytes_per_word
        self.runtime_coarse_grid_solver = runtime_coarse_grid_solver
        self.red_black_penalty = red_black_penalty
        # Per-fused-kernel fixed cost: dominates for tiny coarse grids.
        self.kernel_launch_overhead = kernel_launch_overhead
        # Effective words = counted words / fusion_factor: XLA fuses
        # elementwise chains into stencil passes, so the executable moves
        # fewer words than the reference's unfused per-op count.
        self.fusion_factor = fusion_factor
        # Extra word-fusion of single-partitioned (plain Jacobi) smoothing
        # sweeps, which fuse residual + scale + update into one pass.
        self.single_sweep_fusion = single_sweep_fusion
        # Runtime multiplier of intergrid-transfer passes.
        self.intergrid_factor = intergrid_factor

    def set_runtime_of_coarse_grid_solver(self, runtime: float):
        self.runtime_coarse_grid_solver = runtime

    # -- roofline core -----------------------------------------------------

    def compute_performance(self, intensity: float) -> float:
        return min(self.peak_performance, intensity * self.peak_bandwidth)

    def compute_arithmetic_intensity(self, operations: float, words: float) -> float:
        return operations / (words * self.bytes_per_word)

    def compute_runtime(self, operations: float, words: float, total_operations: float) -> float:
        if operations <= 0.0:
            return 0.0
        words = words / self.fusion_factor
        intensity = self.compute_arithmetic_intensity(operations, words)
        if intensity <= 0.0:
            return 0.0
        return (
            total_operations / self.compute_performance(intensity)
            + self.kernel_launch_overhead
        )

    def compute_bytes(self, operations: float, words: float, total_operations: float) -> float:
        """Modeled HBM traffic of a stencil pass: words/cell × cells.

        `total_operations = operations · cells` at every call site, so the
        cell count is recovered as their ratio."""
        if operations <= 0.0 or words <= 0.0:
            return 0.0
        cells = total_operations / operations
        return (words / self.fusion_factor) * cells * self.bytes_per_word

    # -- per-node op/word counting ----------------------------------------

    @staticmethod
    def _cells(grid_list) -> int:
        grids = grid_list if isinstance(grid_list, list) else [grid_list]
        return min(reduce(lambda a, b: a * b, g.size) for g in grids)

    @staticmethod
    def _stencil_entry_count(entry) -> int:
        stencil = entry.generate_stencil()
        if stencil is None:
            return 0
        cells = periodic.get_list_of_entries(stencil)
        if not cells:
            return 0
        return max(c.number_of_entries for c in cells)

    def _matvec_cost(self, operator, grid):
        """ops/words of one A·x application (no right-hand-side stream)."""
        n_fields = len(grid) if isinstance(grid, list) else 1
        operations = 0
        loads = 0
        offset_union = [set() for _ in range(n_fields)]
        for row in operator.entries:
            for i, entry in enumerate(row):
                stencil = entry.generate_stencil()
                if stencil is None:
                    continue
                cells = periodic.get_list_of_entries(stencil)
                if not cells:
                    continue
                n_entries = max(c.number_of_entries for c in cells)
                operations += 2 * n_entries  # mul + add per coefficient
                for c in cells:
                    for offset, _ in c.entries:
                        offset_union[i].add(offset)
        for s in offset_union:
            loads += len(s)
        return operations, loads + n_fields  # + store

    def _residual_cost(self, residual: base.Residual):
        operations, words = self._matvec_cost(residual.operator, residual.grid)
        grid = residual.grid
        n_fields = len(grid) if isinstance(grid, list) else 1
        return operations, words + n_fields  # + rhs stream

    def _smoother_cost(self, inverse_operand, residual: base.Residual):
        operations_r, words_r = self._residual_cost(residual)
        grid = residual.grid
        n_fields = len(grid) if isinstance(grid, list) else 1
        expression = inverse_operand
        if isinstance(expression, system.Diagonal):
            operations = n_fields + operations_r
            words = n_fields + words_r
        elif isinstance(expression, (system.ElementwiseDiagonal, system.Operator)):
            n = n_fields
            if isinstance(expression, system.Operator):
                for i in range(n_fields):
                    entry = expression.entries[i][i]
                    stencil = entry.generate_stencil()
                    n += len(periodic.count_number_of_entries(stencil)) - 1
            # Gaussian-elimination cost of the n×n local system
            multiplications = round(n**3 / 3 + n**2 - n / 3)
            additions = round(n**3 / 3 + n**2 / 2 - 5 * n / 6)
            operations = multiplications + additions + (n // n_fields) * operations_r
            words = n + (n // n_fields) * words_r
        elif isinstance(expression, base.Addition):
            # FAS Newton: D + J — treat as a collective point solve plus
            # one Jacobian evaluation per Newton step.
            steps = getattr(expression.operand2, "n_newton_steps", 1)
            operations = steps * (3 * n_fields + operations_r)
            words = n_fields + words_r
        else:
            raise NotImplementedError("Smoother not supported by roofline model")
        return operations, words

    def _intergrid_cost(self, operator):
        operations = 0
        words = 0
        for row in operator.entries:
            for entry in row:
                if isinstance(entry, (base.ZeroProlongation, base.ZeroRestriction)):
                    continue
                n = self._stencil_entry_count(entry)
                operations += 2 * n
                words += n + 1
        return operations, words

    # -- recursive runtime + traffic estimation ----------------------------
    # (reference performance.py:50-148, extended to carry modeled bytes)

    def estimate_runtime(self, expression: base.Expression) -> float:
        return self.estimate_runtime_and_traffic(expression)[0]

    def estimate_traffic(self, expression: base.Expression) -> float:
        """Modeled HBM bytes moved by one application of the cycle."""
        return self.estimate_runtime_and_traffic(expression)[1]

    def estimate_runtime_and_traffic(self, expression: base.Expression):
        cached = expression.analysis_cache.get("roofline_runtime")
        if cached is not None:
            return cached
        result = self._estimate(expression, {})
        expression.analysis_cache["roofline_runtime"] = result
        return result

    def _walk(self, expression, visited):
        """Each unique IR node contributes its cost ONCE per cycle
        application: the lowering computes shared subexpressions once
        (multiref handling in backend/lowering.py), so repeat references
        — e.g. the smoothed iterate appearing both as the cycle's
        approximation and inside its residual — add zero marginal cost.
        (The reference's memoized-add estimator double-counts these,
        inflating deep V-cycles ~2× per level.)"""
        key = id(expression)
        if key in visited:
            return 0.0, 0.0
        visited[key] = True
        return self._estimate(expression, visited)

    def _estimate(self, expression, visited):
        if isinstance(expression, base.Cycle):
            correction = expression.correction
            is_smoothing = False
            is_block_solve = False
            ig_pair = None
            if isinstance(correction, base.Residual):
                operations, words = 0, 0
                runtime, traffic = self._walk(correction, visited)
            elif isinstance(correction, base.Multiplication):
                if isinstance(correction.operand1, system.InterGridOperator):
                    runtime, traffic = self._walk(correction.operand2, visited)
                    operations, words = self._intergrid_cost(correction.operand1)
                    ig_pair = (operations, words)
                elif isinstance(correction.operand1, base.Inverse):
                    is_smoothing = True
                    # Block-local solves (system.Operator inverse) execute
                    # as masked coefficient-plane shifts — extra full-grid
                    # arrays that do NOT fuse like an unmasked point-Jacobi
                    # pass, so they keep the undiscounted word count.
                    is_block_solve = isinstance(
                        correction.operand1.operand, system.Operator
                    )
                    residual = correction.operand2
                    visited[id(residual)] = True
                    runtime, traffic = self._dependency_cost(residual, visited)
                    operations, words = self._smoother_cost(
                        correction.operand1.operand, residual
                    )
                else:
                    runtime, traffic = self._walk(correction, visited)
                    operations, words = 0, 0
            else:
                runtime, traffic = self._walk(correction, visited)
                operations, words = 0, 0
            grid = expression.grid
            n_fields = len(grid) if isinstance(grid, list) else 1
            operations += 2 * n_fields  # scale + add of the update
            words += 2 * n_fields  # load + store of the iterate
            is_red_black = expression.partitioning is partitioning.RedBlack or (
                isinstance(expression.partitioning, partitioning.RedBlack)
            )
            if is_smoothing and not is_red_black and not is_block_solve:
                # Plain-Jacobi sweeps fuse residual+scale+update into one
                # unmasked full-grid pass: fewer HBM words than red-black.
                # Block-local solves are excluded.
                words = words / self.single_sweep_fusion
            cells = self._cells(expression.grid)
            step = self.compute_runtime(operations, words, operations * cells)
            step_bytes = self.compute_bytes(operations, words, operations * cells)
            if ig_pair is not None and self.intergrid_factor != 1.0:
                # Surcharge only the transfer part of the pass.
                ig_ops, ig_words = ig_pair
                step += (self.intergrid_factor - 1.0) * self.compute_runtime(
                    ig_ops, ig_words, ig_ops * cells
                )
            if is_red_black:
                step *= self.red_black_penalty
            return runtime + step, traffic + step_bytes

        if isinstance(expression, base.Residual):
            runtime, traffic = self._dependency_cost(expression, visited)
            operations, words = self._residual_cost(expression)
            cells = self._cells(expression.grid)
            return (
                runtime + self.compute_runtime(operations, words, operations * cells),
                traffic + self.compute_bytes(operations, words, operations * cells),
            )

        if isinstance(expression, base.Multiplication):
            op1 = expression.operand1
            if isinstance(op1, system.InterGridOperator):
                runtime, traffic = self._walk(expression.operand2, visited)
                operations, words = self._intergrid_cost(op1)
                cells = self._cells(expression.grid)
                return (
                    runtime
                    + self.intergrid_factor
                    * self.compute_runtime(operations, words, operations * cells),
                    traffic
                    + self.compute_bytes(operations, words, operations * cells),
                )
            if isinstance(op1, base.CoarseGridSolver):
                runtime, traffic = self._walk(expression.operand2, visited)
                if op1.expression is not None and hasattr(op1.expression, "expression"):
                    r2, t2 = self._walk(op1.expression.expression, visited)
                    runtime += r2
                    traffic += t2
                elif self.runtime_coarse_grid_solver:
                    runtime += self.runtime_coarse_grid_solver
                else:
                    # Dense inverse matvec: 2·N² flops, N = coarse
                    # unknowns; the N² matrix is streamed from device
                    # memory each application.
                    n = self._cells(op1.grid) * (
                        len(op1.grid) if isinstance(op1.grid, list) else 1
                    )
                    runtime += max(
                        2.0 * n * n / self.peak_performance,
                        n * n * self.bytes_per_word / self.peak_bandwidth,
                    ) + self.kernel_launch_overhead
                    traffic += n * n * self.bytes_per_word
                return runtime, traffic
            if isinstance(op1, base.Inverse):
                residual = expression.operand2
                visited[id(residual)] = True
                runtime, traffic = self._dependency_cost(residual, visited)
                operations, words = self._smoother_cost(op1.operand, residual)
                cells = self._cells(expression.grid)
                return (
                    runtime
                    + self.compute_runtime(operations, words, operations * cells),
                    traffic
                    + self.compute_bytes(operations, words, operations * cells),
                )
            if isinstance(op1, system.Operator):
                # FAS τ-correction A_c·(R·u): a full operator matvec —
                # previously dropped, leaving FAS cycles under-costed.
                runtime, traffic = self._walk(expression.operand2, visited)
                operations, words = self._matvec_cost(op1, expression.grid)
                cells = self._cells(expression.grid)
                return (
                    runtime
                    + self.compute_runtime(operations, words, operations * cells),
                    traffic
                    + self.compute_bytes(operations, words, operations * cells),
                )
            # Shared `visited` so subexpressions already costed by the
            # caller are not double-counted.
            return self._walk(expression.operand2, visited)

        if isinstance(expression, (base.Addition, base.Subtraction)):
            grid = expression.grid
            n_fields = len(grid) if isinstance(grid, list) else 1
            cells = self._cells(grid)
            ops = n_fields
            words = 3 * n_fields
            r1, t1 = self._walk(expression.operand1, visited)
            r2, t2 = self._walk(expression.operand2, visited)
            return (
                r1 + r2 + self.compute_runtime(ops, words, ops * cells),
                t1 + t2 + self.compute_bytes(ops, words, ops * cells),
            )
        if isinstance(expression, base.Scaling):
            return self._walk(expression.operand, visited)
        if isinstance(expression, (base.Entity, system.System)):
            return 0.0, 0.0
        raise NotImplementedError(f"Roofline: {type(expression).__name__}")

    def _dependency_cost(self, residual: base.Residual, visited):
        runtime, traffic = 0.0, 0.0
        if not isinstance(residual.rhs, system.RightHandSide):
            r, t = self._walk(residual.rhs, visited)
            runtime += r
            traffic += t
        if not isinstance(residual.approximation, system.Approximation) or isinstance(
            residual.approximation, base.Cycle
        ):
            if not type(residual.approximation) in (
                system.Approximation,
                system.ZeroApproximation,
            ):
                r, t = self._walk(residual.approximation, visited)
                runtime += r
                traffic += t
        return runtime, traffic
