"""chip_smoke.py off the card: its refusal without a GPU, each phase at a
tiny size on the CPU (the --multi phase on 4 virtual devices), and the
compile-cache helper every entry point calls."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from graphtpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run_script(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def _assert_refused(cp):
    assert cp.returncode != 0
    assert '"ok"' not in cp.stdout


def test_smoke_refuses_cpu_in_process(capsys):
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("args", [(), ("--multi",)])
def test_smoke_script_refuses_cpu(args):
    _assert_refused(_run_script(REPO, *args))


def test_smoke_script_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    _assert_refused(_run_script(str(tmp_path)))


def test_phase_node2vec_tiny(tmp_path):
    out = chip_smoke.phase_node2vec(
        str(tmp_path), scale=8, n_edges=1500, dim=16, walk_length=10,
        num_walks=2, window=3, walk_sample=100, tv_samples=40_000,
    )
    assert out["tv"] <= chip_smoke.TOL_TV


def test_phase_simrank_cli_tiny(tmp_path):
    rates = chip_smoke.phase_simrank_cli(
        str(tmp_path), n_nodes=300, n_edges=1500, time_reps=1
    )
    assert set(rates) == {"engine", "tree"}
    assert all(r > 0 for r in rates.values())
    assert os.path.getsize(tmp_path / "blog.spmm.sim.txt") > 0


def test_phase_spmm_large_tiny():
    rates = chip_smoke.phase_spmm_large(n_nodes=400, n_edges=1000, time_reps=1)
    assert all(r > 0 for r in rates.values())


def test_phase_exactness_tiny():
    out = chip_smoke.phase_exactness(n_nodes=128, n_edges=600)
    assert np.isfinite(out["dense_default_err"])


def test_phase_copy_rate_tiny():
    assert chip_smoke.phase_copy_rate(n_bytes=1 << 20, reps=2) > 0


def test_phase_multi_on_four_virtual_devices():
    """V=302 divides no 4-device axis, so the sharded SimRank paths pad;
    it stays even so both SGNS runs draw the same batch size."""
    assert len(jax.devices()) >= 4
    out = chip_smoke.phase_multi(
        n_nodes=302, n_edges=1500, n_dev=4, sgns_dim=16, sgns_epochs=1,
        n2v_walkers=64, n2v_steps=5,
    )
    assert set(out) == {"ring spmm", "summa spmm", "sharded dense", "sgns"}


def test_reference_f64_matches_literal_oracle(small_random):
    from graphtpu.simrank.exact import exact_simrank_reference_oracle

    got = chip_smoke.simrank_reference_f64(small_random, 0.6, 3)
    want = exact_simrank_reference_oracle(small_random, 0.6, 3)
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_hops_are_edges_counts_non_edges(ring16):
    walks = np.array([[0, 1, 2, 3], [5, 4, 3, -1], [0, 2, 3, 4]])
    n_hops, bad = chip_smoke.hops_are_edges(ring16, walks)
    assert (n_hops, bad) == (8, 1)  # the -1 pad is skipped; 0->2 is not an edge


def test_check_raises_on_failure(capsys):
    chip_smoke.check("fine", 1.0, 2.0)
    with pytest.raises(chip_smoke.CheckFailed):
        chip_smoke.check("bad", 3.0, 2.0)
    out = capsys.readouterr().out
    assert "check fine: value=1.0 bound=2.0 ok" in out
    assert "check bad: value=3.0 bound=2.0 FAIL" in out


# ----------------------------------------------------------- compile cache


@pytest.fixture
def cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_default_is_in_checkout(monkeypatch, cache_config):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    got = compile_cache.enable_compile_cache()
    assert got == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored


def test_compile_cache_env_var_wins(monkeypatch, tmp_path, cache_config):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None  # JAX reads the env


def _cache_dir_in_fresh_process(env_dir, code):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop(compile_cache.ENV_VAR, None)
    if env_dir is not None:
        env[compile_cache.ENV_VAR] = env_dir
    cp = subprocess.run(
        [sys.executable, "-c",
         "import graphtpu, jax, json; " + code +
         "print(json.dumps(jax.config.jax_compilation_cache_dir))"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert cp.returncode == 0, cp.stderr
    return json.loads(cp.stdout.strip().splitlines()[-1])


def test_importing_graphtpu_sets_no_cache():
    assert _cache_dir_in_fresh_process(None, "") is None


def test_compile_cache_lands_in_env_dir(tmp_path):
    got = _cache_dir_in_fresh_process(
        str(tmp_path),
        "from graphtpu.utils.compile_cache import enable_compile_cache; "
        "enable_compile_cache(); ",
    )
    assert got == str(tmp_path)


# ------------------------------------------------------------------ bench


def test_bench_refuses_cpu(capsys):
    import bench

    assert bench.main([]) != 0
    assert capsys.readouterr().out == ""


def test_bench_simrank_timers_tiny():
    import bench

    g = bench.rmat(200, 800, 0)
    assert bench.dense_metrics(g, iters=2) > 0
    out = bench.spmm_metrics(g, "tiny", iters=2)
    assert set(out) == {"spmm_tiny_ms_per_iter", "spmm_tiny_gbps"}
    assert all(v > 0 for v in out.values())
