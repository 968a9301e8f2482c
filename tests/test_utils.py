"""Utility-layer tests: logbooks, halls of fame, visualization files."""

import os

import pytest

import jax.numpy as jnp
import numpy as np

from evostencils_tpu.grammar.gp import Terminal, Tree
from evostencils_tpu.utils.logbook import HallOfFame, Logbook, MultiStatistics, Statistics
from evostencils_tpu.utils.visualization import draw_tree


def ind(name, fit):
    t = Tree([Terminal(name, None, 1)])
    t.fitness_values = fit
    return t


class TestLogbook:
    def test_record_select_stream(self):
        lb = Logbook()
        lb.record(gen=0, nevals=8, fitness={"min": 1.0, "avg": 2.0})
        lb.record(gen=1, nevals=4, fitness={"min": 0.5, "avg": 1.5})
        gens, nevals = lb.select("gen", "nevals")
        assert gens == [0, 1] and nevals == [8, 4]
        assert "gen=1" in lb.stream and "min=0.5" in lb.stream

    def test_statistics_ignore_infinities(self):
        stats = Statistics(lambda i: i.fitness_values[0])
        stats.register("min", np.min)
        pop = [ind("a", (1.0,)), ind("b", (float("inf"),))]
        assert stats.compile(pop)["min"] == 1.0

    def test_multistatistics_fields(self):
        ms = MultiStatistics(
            fitness=Statistics(lambda i: i.fitness_values[0]),
            size=Statistics(len),
        )
        ms.register("avg", np.mean)
        record = ms.compile([ind("a", (2.0,)), ind("b", (4.0,))])
        assert record["fitness"]["avg"] == 3.0
        assert record["size"]["avg"] == 1.0


class TestHallOfFame:
    def test_keeps_best_and_dedups(self):
        hof = HallOfFame(2)
        hof.update([ind("a", (3.0,)), ind("b", (1.0,)), ind("a", (2.0,))])
        assert [str(i) for i in hof] == ["a", "b"] or [str(i) for i in hof] == ["b", "a"]
        assert hof[0].fitness_values == (1.0,)
        # better duplicate replaces the stored one
        hof.update([ind("b", (0.5,))])
        assert hof[0].fitness_values == (0.5,)


class TestVisualization:
    def test_draw_tree_writes_dot(self, tmp_path, rng):
        from evostencils_tpu.grammar import gp
        from evostencils_tpu.grammar.multigrid import generate_primitive_set
        from evostencils_tpu.problems.poisson import poisson_2d

        problem = poisson_2d(min_level=3, max_level=4, dtype=jnp.float64)
        pset, _ = generate_primitive_set(
            problem.approximation(), problem.rhs(), 2, problem.coarsening_factors,
            4, problem.equations, problem.operators, problem.fields, depth=1,
            maximum_local_system_size=4,
        )
        tree = gp.gen_grow(pset, 2, 8, rng=rng)
        path = draw_tree(tree, str(tmp_path / "tree"))
        assert os.path.isfile(path)
        content = open(path).read()
        assert content.startswith("digraph")


class TestProfiling:
    def test_trace_degrades_gracefully(self, tmp_path):
        import jax.numpy as jnp

        from evostencils_tpu.utils.profiling import trace

        with trace(str(tmp_path / "trace")):
            x = jnp.ones((8, 8)) * 2.0
        assert float(x[0, 0]) == 2.0

    def test_evaluation_report_counters(self):
        import jax.numpy as jnp

        from evostencils_tpu.backend.evaluation import JaxProgramGenerator
        from evostencils_tpu.problems.poisson import poisson_2d
        from evostencils_tpu.utils.profiling import evaluation_report

        gen = JaxProgramGenerator(
            poisson_2d(min_level=3, max_level=4, dtype=jnp.float64),
            dtype=jnp.float64,
        )
        report = evaluation_report(gen)
        assert {"compile_time_s", "run_time_s", "vm_hits",
                "vm_hit_rate", "device_failures"} <= set(report)
        assert report["device_failures"] == 0

    def test_bandwidth_utilization_fields(self):
        import jax.numpy as jnp

        from evostencils_tpu.grammar.multigrid import generate_primitive_set
        from evostencils_tpu.ir.reference_cycles import generate_v_cycle
        from evostencils_tpu.problems.poisson import poisson_2d
        from evostencils_tpu.utils.profiling import bandwidth_utilization

        problem = poisson_2d(min_level=3, max_level=5, dtype=jnp.float64)
        _, tl = generate_primitive_set(
            problem.approximation(), problem.rhs(), 2,
            problem.coarsening_factors, 5, problem.equations,
            problem.operators, problem.fields, depth=2,
            maximum_local_system_size=4,
        )
        cycle = generate_v_cycle(tl, problem.rhs(), 2, 1)
        out = bandwidth_utilization(cycle, 1e-3, "NVIDIA H100 80GB HBM3")
        assert out["modeled_bytes"] > 0
        assert out["achieved_GBps"] > 0
        assert out["utilization_pct_upper_bound"] == pytest.approx(
            100.0 * out["modeled_bytes"] / 1e-3 / 3.35e12, abs=0.05)


def test_champion_helpers_roundtrip(tmp_path):
    """parse_champion_file + apply_stored_omegas: stored omegas apply in
    collect_cycles order when counts match, warn-and-keep otherwise."""
    import jax.numpy as jnp

    from evostencils_tpu.grammar.multigrid import generate_primitive_set
    from evostencils_tpu.ir.reference_cycles import generate_v_cycle
    from evostencils_tpu.ir.transformations import collect_cycles
    from evostencils_tpu.problems.poisson import poisson_2d
    from evostencils_tpu.utils.champions import (
        apply_stored_omegas, omega_index, parse_champion_file,
    )

    p = tmp_path / "champ.txt"
    p.write_text("# comment first\nsome_tree_string(u_and_f)\n"
                 "# tuned omegas: [0.8, 1.2]\n")
    tree, omegas = parse_champion_file(str(p))
    assert tree == "some_tree_string(u_and_f)"
    assert omegas == [0.8, 1.2]

    problem = poisson_2d(min_level=3, max_level=5, dtype=jnp.float64)
    _, tl = generate_primitive_set(
        problem.approximation(), problem.rhs(), 2, problem.coarsening_factors,
        5, problem.equations, problem.operators, problem.fields, depth=2,
    )
    expr = generate_v_cycle(tl, problem.rhs(), 2, 1, omega=0.6)
    n = len(collect_cycles(expr))
    good = [0.5 + 0.01 * i for i in range(n)]
    assert apply_stored_omegas(expr, good, label="t") is True
    assert [c.relaxation_factor for c in collect_cycles(expr)] == good
    # Mismatched count: refused, factors unchanged.
    assert apply_stored_omegas(expr, [0.9], label="t") is False
    assert [c.relaxation_factor for c in collect_cycles(expr)] == good
    assert apply_stored_omegas(expr, None) is False

    assert omega_index(0.1) == 0
    assert omega_index(1.9) == 36
    assert omega_index(0.6) == 10
    assert omega_index(-5.0) == 0 and omega_index(99.0) == 36


class TestPeaks:
    def test_h100_lookup(self):
        from evostencils_tpu.utils.peaks import peaks_for

        peaks = peaks_for("NVIDIA H100 80GB HBM3")
        assert peaks.hbm_bytes_per_s == 3.35e12
        assert peaks.f32_flops == 67e12
        assert "data sheet" in peaks.source

    @pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB"])
    def test_unknown_device_raises(self, kind):
        from evostencils_tpu.models.roofline import PerformanceEvaluator
        from evostencils_tpu.utils.peaks import peaks_for

        with pytest.raises(KeyError, match="no published peaks"):
            peaks_for(kind)
        with pytest.raises(KeyError):
            PerformanceEvaluator(device_kind=kind)


_CACHE_PROBE = (
    "import jax; from evostencils_tpu.utils import enable_persistent_compile_cache as e;"
    "d = e(); print(d); print(jax.config.jax_compilation_cache_dir)"
)


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_placement(env_dir, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins and is left alone; otherwise the
    cache goes to the fixed <repo>/.jax_cache."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=repo)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    out = subprocess.run([sys.executable, "-c", _CACHE_PROBE], env=env,
                         cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    returned, configured = out.stdout.split()
    want = (str(tmp_path / env_dir) if env_dir is not None
            else os.path.join(repo, ".jax_cache"))
    assert returned == want
    assert configured == want
