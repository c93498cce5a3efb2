"""Device decision, solver gates, compile cache, GPU-only entry points and
per-card worker assignment."""

import os
import queue
import subprocess
import sys

import jax
import numpy as np
import pytest

from privacy_preserving_sfm_tpu.optim import ba, ba_dense, schur_pcg
from privacy_preserving_sfm_tpu.sfm import incremental_mapper
from privacy_preserving_sfm_tpu.utils import gpu_workers, jax_setup

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _FakeDevice:
    def __init__(self, platform):
        self.platform = platform


@pytest.mark.parametrize("platform", ["cpu", "gpu", "rocm", "METAL"])
def test_accelerator_reports_gpu_or_cpu_only(monkeypatch, platform):
    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeDevice(platform)])
    if platform in ("cpu", "gpu"):
        assert jax_setup.accelerator() == platform
    else:
        with pytest.raises(RuntimeError, match="unsupported JAX platform"):
            jax_setup.accelerator()


def test_accelerator_on_this_host_is_cpu():
    assert jax_setup.accelerator() == "cpu"


@pytest.mark.parametrize("device,explicit", [("gpu", True), ("cpu", False)])
def test_dense_auto_schur_mode_follows_the_device(monkeypatch, device,
                                                  explicit):
    """schur_mode="auto" materializes S (one Gram) on the GPU only."""
    from test_ba_soa import _make_problem

    calls = []
    orig = schur_pcg.gram
    monkeypatch.setattr(schur_pcg, "gram",
                        lambda *a: calls.append(1) or orig(*a))
    monkeypatch.setattr(ba_dense, "accelerator", lambda: device)
    dense = ba_dense.from_flat_problem(
        _make_problem(np.random.default_rng(0)), k_bucket=4)
    jax.make_jaxpr(lambda p: ba_dense.bundle_adjust_dense(
        p, "SIMPLE_PINHOLE", ba.BAOptions(max_iterations=2)))(dense)
    assert bool(calls) == explicit


@pytest.mark.parametrize("device,cams,ba_path,schur_mode,expect", [
    ("gpu", 100, "", "auto", "soa"),
    ("gpu", 1024, "", "explicit", "soa"),
    ("gpu", 1088, "", "auto", "dense"),
    ("gpu", 100, "", "implicit", "dense"),
    ("gpu", 100, "flat", "auto", "flat"),
    ("cpu", 100, "", "auto", "flat"),
    ("cpu", 100, "soa", "auto", "soa"),
])
def test_mapper_solver_choice(monkeypatch, device, cams, ba_path,
                              schur_mode, expect):
    monkeypatch.setattr(incremental_mapper, "accelerator", lambda: device)
    assert incremental_mapper.choose_ba_solver(
        cams, ba_path, schur_mode) == expect


@pytest.fixture
def _keep_cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_cache_dir_from_environment(monkeypatch, tmp_path,
                                    _keep_cache_config):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jax_setup.enable_persistent_cache() == str(tmp_path)
    # JAX reads the variable itself; no other directory is configured.
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_default_is_inside_the_checkout(monkeypatch,
                                                  _keep_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = jax_setup.enable_persistent_cache()
    assert jax.config.jax_compilation_cache_dir == path
    assert os.path.dirname(path) == jax_setup.DEFAULT_CACHE_DIR
    assert os.path.basename(path).startswith("cpu_")  # JAX_PLATFORMS=cpu
    assert jax_setup.DEFAULT_CACHE_DIR == os.path.join(ROOT, ".jax_cache")
    with open(os.path.join(ROOT, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_peak_table():
    sys.path.insert(0, ROOT)
    import bench

    assert bench.device_peaks("NVIDIA H100 80GB HBM3")["f32_flops"] == 67e12
    with pytest.raises(KeyError, match="no published peaks"):
        bench.device_peaks("AMD Instinct MI300X")


def _run_cpu(args, cwd):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_entry_points_refuse_to_run_without_a_gpu(script):
    r = _run_cpu([os.path.join(ROOT, script)], ROOT)
    assert r.returncode != 0
    assert "no GPU found" in r.stderr
    assert r.stdout.strip() == "" or "{" not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run_cpu([str(tmp_path / "chip_smoke.py")], tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("visible,n,expect", [
    ("0,1,2,3", 4, ["0", "1", "2", "3"]),
    ("0,1,2,3", 2, ["0", "1"]),
    ("2,5", 2, ["2", "5"]),
    ("", 3, [None, None, None]),
])
def test_worker_card_assignment(monkeypatch, visible, n, expect):
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    assert gpu_workers.assign_gpus(n) == expect


def test_more_workers_than_cards_is_an_error(monkeypatch):
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2,3")
    with pytest.raises(ValueError, match="exceeds the 4 GPU"):
        gpu_workers.assign_gpus(5)


def test_cpu_workers_are_not_pinned(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1")
    assert gpu_workers.assign_gpus(8, platform="cpu") == [None] * 8
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert gpu_workers.assign_gpus(8) == [None] * 8


def test_pin_worker_gpu_sets_the_visible_card(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2,3")
    q = queue.Queue()
    q.put("2")
    gpu_workers.pin_worker_gpu(q)
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "2"
