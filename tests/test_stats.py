"""PerformanceStats + bracketed-tag logging (SURVEY.md §5.1/§5.5;
reference: include/renderer/PerformanceStats.h:12-114)."""

import logging

from metal_pathtracer.utils import stats


def test_perf_stats_derivations():
    p = stats.PerformanceStats()
    # one batch: 4 spp over a 10x10 image in 2s, 1000 scene + 500 shadow rays
    p.update(samples=4, seconds=2.0, width=10, height=10,
             ray_count=1000.0, shadow_ray_count=500.0)
    assert p.total_samples == 4
    assert p.samples_per_minute == 120.0
    assert abs(p.mrays_per_second - 1500.0 / 2.0 / 1e6) < 1e-12
    assert abs(p.rays_per_sample - 1500.0 / (4 * 100)) < 1e-12
    assert abs(p.shadow_ray_fraction - 1.0 / 3.0) < 1e-12

    # second batch: counters are cumulative, only deltas count
    p.update(samples=4, seconds=2.0, width=10, height=10,
             ray_count=1800.0, shadow_ray_count=700.0)
    assert p.total_samples == 8
    assert abs(p.rays_per_sample - 1000.0 / 400) < 1e-12
    assert "spp" in p.summary() and "Mrays/s" in p.summary()


def test_perf_stats_ignores_empty_batch():
    p = stats.PerformanceStats()
    p.update(samples=0, seconds=0.0, width=8, height=8)
    assert p.total_samples == 0


def test_tagged_logger(capsys):
    log = stats.get_logger("Timing")
    stats.set_verbose(False)
    log.info("hello %d", 7)
    out = capsys.readouterr().out
    assert "[Timing] hello 7" in out
    # DEBUG suppressed at default level, enabled with verbose
    log.debug("quiet")
    assert "quiet" not in capsys.readouterr().out
    stats.set_verbose(True)
    log.debug("loud")
    assert "[Timing] loud" in capsys.readouterr().out
    stats.set_verbose(False)


def test_logger_tags_are_per_adapter(capsys):
    a = stats.get_logger("Output")
    b = stats.get_logger("Renderer")
    a.info("one")
    b.info("two")
    out = capsys.readouterr().out
    assert "[Output] one" in out and "[Renderer] two" in out
